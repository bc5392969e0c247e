"""The engine's per-bucket executables as CUDA graphs
(``serving/generation.py``: ``graph_plan``, the buffer-driven device
functions, ``_device_call``) against the JAX engine on the CPU, at the
tiny d64 x L2 LM:

- the warm set: ``graph_plan()`` equals the keys of the executables
  the JAX engine's ``warmup()`` compiles (its compiles recorded, not
  run) for slots, paged with sharing on and off, paged with the host
  KV tier on (a gather and a scatter per run bucket), speculating at
  k=3 on both backends, and paged with a verify bucket wider than the
  chunk cap; an engine whose captures are recorded (each "replay" runs
  the captured function) captures exactly that plan at warmup and
  nothing after, a recovery included, or demotions and restores on the
  KV tier, and an engine never warmed captures a key at its second
  call, with the tokens of the eager engine;
- the buffer-driven prefill, chunk, copy-on-write, draft prime and
  verify, run from their static buffers over seeded (p0, slot, length,
  table) values, equal the host-argument path bit for bit (token, ok,
  logits, every cache) and the JAX functions: token and ok exactly,
  tgt and n_accepted exactly, logits within 1e-5 (int8 caches: 1e-3),
  caches within 1e-6 of their largest magnitude (int8: the scales, and
  the values equal but one step at a rounding boundary);
- a slot verify span past the panel's end writes exactly JAX's panel.

The graphs themselves run only on the card (``test_torch_kernels_gpu``
and ``chip_smoke.py``)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import kv_quant as jkv
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import generation as jgen
from deeplearning4j_tpu.serving import speculative as jspec
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.faults import FaultInjector
from deeplearning4j_tpu_torch.kernels import kv_quant as tkv
from deeplearning4j_tpu_torch.serving import GenerationEngine
from deeplearning4j_tpu_torch.serving import speculative as tspec
from deeplearning4j_tpu_torch.serving.generation import (_sample_from_logits,
                                                         _uniforms)
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM
from _torch_threads import one_torch_thread  # noqa: F401,E402

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=2,
           max_seq_len=64)
LOGIT_TOL = 1e-5   # f32 on both sides, sums in another order
#: int8 caches: attention takes bf16 operands, and an f32 value a few
#: ulps from JAX's may round to the other bf16 or int8 neighbour
#: (tests/test_torch_int8_attention.py's TOL_LAYER; 1.2e-4 measured)
LOGIT_TOL_INT8 = 1e-3
#: relative to each pool's largest magnitude: a layer's K/V are one
#: projection of its input, which carries the earlier layers' f32
#: rounding (2.8e-6 absolute at the second layer on values up to ~5).
#: int8 pools: the scales within it, and the int8 values equal but
#: where a value sits on a rounding boundary (one step, at most one in
#: a thousand; one of 12,288 measured)
CACHE_TOL = 1e-6

PAGED = dict(cache="paged", block_size=8, prefill_chunk_tokens=16)
#: the warm-set configurations (JAX's keyword arguments)
CONFIGS = {
    "slots": dict(),
    "paged_sharing": dict(PAGED),
    "paged_no_sharing": dict(PAGED, enable_prefix_sharing=False),
    "paged_offload": dict(PAGED, num_blocks=12, offload_host_bytes=1 << 20),
    "slots_k3": dict(speculation_k=3),
    "paged_k3": dict(PAGED, speculation_k=3),
    # verify bucket 8 wider than the chunk cap 4: JAX sizes the table
    # ladder by the wider of the two
    "paged_k4_vbucket_over_cap": dict(cache="paged", block_size=4,
                                      prefill_chunk_tokens=4,
                                      speculation_k=4),
}


def _port(jmodel):
    return CausalTransformerLM(**CFG, seed=jmodel.seed,
                               device="cpu").load_params(
        jax.tree.map(np.asarray, jmodel._params))


@pytest.fixture(scope="module")
def jlm():
    return JaxLM(**CFG, seed=5, implementation="plain").init()


@pytest.fixture(scope="module")
def lm(jlm):
    return _port(jlm)


@pytest.fixture(scope="module")
def jdraft():
    # a same-config draft of other weights: proposals that sometimes
    # match, sometimes not
    return JaxLM(**CFG, seed=9, implementation="plain").init()


@pytest.fixture(scope="module")
def draft(jdraft):
    return _port(jdraft)


def _kw(name, draft_model):
    kw = dict(num_slots=2, max_queue=16, min_prompt_bucket=8,
              **CONFIGS[name])
    if kw.get("speculation_k"):
        kw["draft_model"] = draft_model
    return kw


def _jax_keys(je) -> set:
    """The JAX engine's compiled executables as graph_plan keys."""
    keys = set()
    if je._decode_exe is not None:
        keys.add(("decode",))
    for k in je._prefill_exe:
        keys.add(("chunk",) + k if isinstance(k, tuple) else ("prefill", k))
    if je._cow_exe is not None:
        keys.add(("cow",))
    if je._draft_exe is not None:
        keys.add(("propose",))
    keys |= {("prime", b) for b in je._draft_prime_exe}
    keys |= {("verify",) if k == "slots" else ("verify", k)
             for k in je._verify_exe}
    keys |= {("offload_save", b) for b in je._offload_save_exe}
    keys |= {("offload_load", b) for b in je._offload_load_exe}
    return keys


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_plan_is_the_jax_warm_set(name, monkeypatch, jlm, lm, jdraft,
                                        draft):
    monkeypatch.setattr(jgen, "compile_memoized",
                        lambda fn, args, donate=(): object())
    je = JaxEngine(jlm, **_kw(name, jdraft))
    te = GenerationEngine(lm, **_kw(name, draft))
    try:
        je.warmup()
        want = _jax_keys(je)
        plan = te.graph_plan()
        assert len(plan) == len(set(plan)) == je.metrics.compiles
        assert set(plan) == want
        if te.cache_backend == "paged":
            assert te._tbl_top == je._tbl_top
        # a narrowed warmup narrows the prompt or chunk buckets alone
        first = (te.chunk_buckets if te.cache_backend == "paged"
                 else te.prompt_buckets)[:1]
        narrow = te.graph_plan(first)
        assert {k for k in narrow if k[0] in ("prefill", "chunk")} == \
            {k for k in plan if k[0] in ("prefill", "chunk")
             and k[1] == first[0]}
    finally:
        je.stop()
        te.stop()


class _Recorded:
    """A recorded capture: its "replay" runs the captured function, so
    the engine's graph ladder runs on the CPU as it does on the card."""

    def __init__(self, run):
        self.replay = run


def _recording(eng):
    """Switch ``eng`` to its card behaviour with recorded captures.
    Returns the list of captured names."""
    names = []

    def capture(run, what, shared=False):
        names.append(what)
        eng.metrics.inc("compiles")
        return _Recorded(run), {}

    eng._cuda_graph = True
    eng._capture = capture
    return names


REQS = [dict(prompt=list(range(1, 6)), max_tokens=9),
        dict(prompt=list(range(3, 24)), max_tokens=7, temperature=0.8,
             top_k=8, seed=4),
        dict(prompt=list(range(2, 13)), max_tokens=12, seed=5),
        dict(prompt=list(range(7, 40)), max_tokens=6)]


def _serve(eng, reqs=REQS):
    return [eng.generate(timeout_ms=60_000, **r)["tokens"] for r in reqs]


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_warmup_captures_the_plan_and_nothing_after(backend, lm, draft):
    """A speculating engine (every graph kind of its backend) captures
    its plan at warmup and nothing after, a corrupting verify's
    recovery included; its tokens are the eager engine's. An engine
    never warmed captures each key at its second call."""
    kw = _kw("paged_k3" if backend == "paged" else "slots_k3", draft)
    eager = GenerationEngine(lm, **kw)
    eng = GenerationEngine(lm, **kw)
    lazy = GenerationEngine(lm, **kw)
    try:
        eager.warmup()
        want = _serve(eager)
        names = _recording(eng)
        eng.warmup()
        plan = eng.graph_plan()
        assert eng.metrics.compiles == len(plan) == len(names)
        assert set(eng._graphs) == {k for k in plan
                                    if k[0] not in ("decode", "propose")}
        assert _serve(eng) == want
        eng.set_fault_injector(FaultInjector(plan={"verify": [2]},
                                             corrupting=("verify",)))
        assert _serve(eng) == want
        eng.set_fault_injector(None)
        assert eng.metrics.recoveries == 1
        assert eng.metrics.compiles == len(plan) == len(names)

        lazy_names = _recording(lazy)
        calls = count_calls(lazy)
        assert _serve(lazy) == want
        again = {k for k, n in calls.items() if n >= 2}
        assert set(lazy._graphs) == again and again <= set(plan)
        assert lazy.metrics.compiles == len(lazy_names) == \
            len(again) + (lazy._graph is not None) \
            + (lazy._draft_graph is not None)
    finally:
        eager.stop()
        eng.stop()
        lazy.stop()


def test_offload_traffic_captures_nothing_after_warmup(lm):
    """The KV tier's gather and scatter are graphs of the plan: an
    engine with recorded captures demotes and restores sessions (the
    pool pins ~1 of 3) with no capture after warmup, and gives the
    tokens of an eager engine that never offloads. An engine never
    warmed captures a run bucket's gather and scatter at their second
    calls only."""
    kw = _kw("paged_offload", None)
    hot = GenerationEngine(lm, **dict(kw, num_blocks=64,
                                      offload_host_bytes=0))
    eng = GenerationEngine(lm, **kw)
    lazy = GenerationEngine(lm, **kw)
    prompts = [list(range(1 + i, 25 + i)) for i in range(3)]

    def two_turns(e):
        outs = [e.generate(p, max_tokens=6, session_id=f"s{i}",
                           timeout_ms=60_000)["tokens"]
                for i, p in enumerate(prompts)]
        return outs + [e.generate(p + o + [3, 5], max_tokens=5,
                                  session_id=f"s{i}",
                                  timeout_ms=60_000)["tokens"]
                       for i, (p, o) in enumerate(zip(prompts, outs))]
    try:
        hot.warmup()
        want = two_turns(hot)
        names = _recording(eng)
        eng.warmup()
        plan = eng.graph_plan()
        assert eng.metrics.compiles == len(plan) == len(names)
        assert two_turns(eng) == want
        off = eng.stats()["paged"]["offload"]
        assert off["demotions"] > 0 and off["restores"] > 0
        assert eng.metrics.compiles == len(plan) == len(names)
        lazy_names = _recording(lazy)
        calls = count_calls(lazy)
        assert two_turns(lazy) == want
        again = {k for k, n in calls.items() if n >= 2}
        assert {k for k in lazy._graphs if k[0].startswith("offload")} == \
            {k for k in again if k[0].startswith("offload")}
        assert any(k[0] == "offload_load" for k in again)
        assert lazy.metrics.compiles == len(lazy_names)
    finally:
        hot.stop()
        eng.stop()
        lazy.stop()


def count_calls(eng) -> dict:
    """Count ``eng``'s per-bucket device calls by graph key."""
    calls = {}
    call = eng._device_call

    def counted(key, *a, **k):
        calls[key] = calls.get(key, 0) + 1
        return call(key, *a, **k)
    eng._device_call = counted
    return calls


# ---------------------------------------------------------------------------
# the buffer-driven functions
# ---------------------------------------------------------------------------
def _seed_pools(pools, rs):
    """Fill the port's pools with seeded values (int8: quantized);
    returns their JAX copies."""
    out = []
    for p in pools:
        x = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        if tkv.is_quantized(p):
            qv = tkv.quantize_rows(x)
            p.q.copy_(qv.q)
            p.scale.copy_(qv.scale)
            out.append(jkv.QuantArray(jnp.asarray(p.q.numpy()),
                                      jnp.asarray(p.scale.numpy())))
        else:
            p.copy_(x)
            out.append(jnp.asarray(p.numpy()))
    return out


def _clone(pools):
    return [tkv.QuantArray(p.q.clone(), p.scale.clone())
            if tkv.is_quantized(p) else p.clone() for p in pools]


def _same_bits(a, b):
    for x, y in zip(a, b):
        if tkv.is_quantized(x):
            assert torch.equal(x.q, y.q) and torch.equal(x.scale, y.scale)
        else:
            assert torch.equal(x, y)


def _near(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=CACHE_TOL * max(1.0, float(np.abs(want).max())))


def _near_jax(port, jax_pools):
    for x, y in zip(port, jax_pools):
        if not tkv.is_quantized(x):
            _near(x.numpy(), np.asarray(y))
            continue
        _near(x.scale.numpy(), np.asarray(y.scale))
        step = np.abs(x.q.numpy().astype(np.int32)
                      - np.asarray(y.q).astype(np.int32))
        assert step.max() <= 1 and step.mean() <= 1e-3


def _logits_near(got, want, kv_dtype):
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=LOGIT_TOL_INT8 if kv_dtype == "int8" else LOGIT_TOL)


def _recorder(model, name):
    """Record the logits of ``model``'s ``name`` forward (an instance
    attribute over the method; the caller deletes it)."""
    seen = []
    fn = getattr(model, name)

    def rec(*a, **k):
        out = fn(*a, **k)
        seen.append(out[0].clone())
        return out
    setattr(model, name, rec)
    return seen


def _req(rs):
    temp = float(rs.choice([0.0, 0.9]))
    return types.SimpleNamespace(temperature=temp,
                                 top_k=int(rs.choice([0, 8])),
                                 seed=int(rs.randint(1 << 30)))


def _first_ref(logits_row, req):
    u = (_uniforms(np.array([req.seed], np.uint32), np.zeros(1, np.int32))
         if req.temperature > 0 else torch.zeros(1))
    return int(_sample_from_logits(
        logits_row[None], torch.tensor([req.temperature]),
        torch.tensor([req.top_k]), u)[0])


@pytest.fixture()
def engines(lm, jlm):
    made = []

    def make(cls, model, **kw):
        eng = cls(model, max_queue=8, min_prompt_bucket=8, **kw)
        eng.stop()  # the test thread drives the device calls
        made.append(eng)
        return eng
    yield make
    for e in made:
        e.stop()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefill_from_its_buffers(kv_dtype, lm, jlm, engines):
    eng = engines(GenerationEngine, lm, num_slots=3, kv_dtype=kv_dtype)
    je = engines(JaxEngine, jlm, num_slots=3, kv_dtype=kv_dtype)
    rs = np.random.RandomState(1)
    jk = _seed_pools(eng._kcs, rs)
    jv = _seed_pools(eng._vcs, rs)
    params = lm._params
    for _ in range(3):
        L = int(rs.randint(1, 40))
        bucket, slot, req = eng._bucket(L), int(rs.randint(3)), _req(rs)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :L] = rs.randint(VOCAB, size=L)
        # the host-argument path on copies of the caches
        kc, vc = _clone(eng._kcs), _clone(eng._vcs)
        mask = (torch.arange(bucket)[None] < L).float()
        logits, ks, vs = lm.forward_prefill(params, torch.from_numpy(tokens),
                                            mask)
        for c, k in zip(kc + vc, ks + vs):
            tkv.kv_update_slice(c, k, (slot, 0, 0, 0))
        want = (_first_ref(logits[0, L - 1], req),
                bool(torch.isfinite(logits).all()))
        seen = _recorder(lm, "forward_prefill")
        try:
            first, ok, _ = eng._prefill_call(tokens, L, slot, req)
        finally:
            del lm.forward_prefill
        assert (first, ok) == want
        assert torch.equal(seen[0], logits)
        _same_bits(eng._kcs + eng._vcs, kc + vc)
        jf, jok, jk, jv = je._prefill_fn()(
            jlm._params, jk, jv, jnp.asarray(tokens, jnp.int32), L, slot,
            req.seed, req.temperature, req.top_k)
        assert (int(jf), bool(jok)) == want
        jl, _, _ = jlm.forward_prefill(jlm._params,
                                       jnp.asarray(tokens, jnp.int32),
                                       jnp.asarray(mask.numpy()))
        _logits_near(seen[0].numpy(), np.asarray(jl), kv_dtype)
        _near_jax(eng._kcs + eng._vcs, jk + jv)


def _paged_table(eng, rs, n_used, tbl):
    """``n_used`` distinct non-null blocks, NULL-padded to ``tbl``."""
    blocks = rs.permutation(np.arange(1, eng.num_blocks))[:n_used]
    table = np.zeros(tbl, np.int32)
    table[:n_used] = blocks
    return table


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_chunk_and_cow_from_their_buffers(kv_dtype, lm, jlm, engines):
    kw = dict(PAGED, num_slots=2, num_blocks=24, kv_dtype=kv_dtype)
    eng = engines(GenerationEngine, lm, **kw)
    je = engines(JaxEngine, jlm, **kw)
    rs = np.random.RandomState(2)
    jk = _seed_pools(eng._kcs, rs)
    jv = _seed_pools(eng._vcs, rs)
    params, bs = lm._params, eng.block_size
    for _ in range(3):
        c = int(rs.choice(eng.chunk_buckets))
        clen = int(rs.randint(1, c + 1))
        p0 = int(rs.randint(0, 40))
        tbl = int(rs.choice([t for t in eng._tbl_buckets
                             if t * bs >= p0 + c]))
        table = _paged_table(eng, rs, min(tbl, -(-(p0 + c) // bs)), tbl)
        req = _req(rs)
        tokens = np.zeros((1, c), np.int64)
        tokens[0, :clen] = rs.randint(VOCAB, size=clen)
        kc, vc = _clone(eng._kcs), _clone(eng._vcs)
        logits, _, _ = lm.forward_prefill_chunk(
            params, torch.from_numpy(tokens), p0, clen, kc, vc,
            torch.from_numpy(table))
        want = (_first_ref(logits[clen - 1], req),
                bool(torch.isfinite(logits[:clen]).all()))
        seen = _recorder(lm, "forward_prefill_chunk")
        try:
            first, ok, _ = eng._chunk_call(tokens, p0, clen, table, req)
        finally:
            del lm.forward_prefill_chunk
        assert (first, ok) == want
        assert torch.equal(seen[0], logits)
        _same_bits(eng._kcs + eng._vcs, kc + vc)
        jtok, jtbl = jnp.asarray(tokens, jnp.int32), jnp.asarray(table)
        jl, _, _ = jlm.forward_prefill_chunk(jlm._params, jtok, p0, clen,
                                             jk, jv, jtbl)
        jf, jok, jk, jv = je._chunk_fn()(jlm._params, jk, jv, jtok, p0, clen,
                                         jtbl, req.seed, req.temperature,
                                         req.top_k)
        assert (int(jf), bool(jok)) == want
        _logits_near(seen[0].numpy(), np.asarray(jl), kv_dtype)
        _near_jax(eng._kcs + eng._vcs, jk + jv)
    for _ in range(3):
        src, dst = (int(b) for b in rs.choice(np.arange(1, 24), 2, False))
        kc, vc = _clone(eng._kcs), _clone(eng._vcs)
        for pool in kc + vc:
            tkv.kv_copy_row(pool, src, dst)
        eng._cow(src, dst)
        _same_bits(eng._kcs + eng._vcs, kc + vc)
        jk, jv = je._cow_fn()(jk, jv, src, dst)
        _near_jax(eng._kcs + eng._vcs, jk + jv)


def test_prime_from_its_buffers(lm, jlm, draft, jdraft, engines):
    eng = engines(GenerationEngine, lm, num_slots=3, speculation_k=3,
                  draft_model=draft)
    rs = np.random.RandomState(3)
    dc = eng._draft_cache
    jk = _seed_pools(dc.ks, rs)
    jv = _seed_pools(dc.vs, rs)
    prime = jspec.make_prime_fn(jdraft)
    for _ in range(4):
        L = int(rs.randint(1, 60))
        bucket = next(b for b in eng._prime_buckets if b >= L)
        slot = int(rs.randint(3))
        seq = rs.randint(VOCAB, size=L)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :L] = seq
        kc, vc = _clone(dc.ks), _clone(dc.vs)
        want = bool(eng._prime_fn(draft._params, kc, vc,
                                  torch.from_numpy(tokens), L, slot))
        out, _ = eng._device_call(("prime", bucket), eng._prime_in,
                                  eng._prime_out, tok=seq, length=L,
                                  slot=slot)
        assert bool(out[0]) == want
        _same_bits(dc.ks + dc.vs, kc + vc)
        jok, jk, jv = prime(jdraft._params, jk, jv,
                            jnp.asarray(tokens, jnp.int32), L, slot)
        assert bool(jok) == want
        _near_jax(dc.ks + dc.vs, jk + jv)


def _verify_ref(lm, kc, vc, tokens, p0, vlen, where, req, step0, paged):
    """The host-argument verify: the model's span forward with host ints
    and the host-scalar ``_verify_tail``."""
    tok = torch.from_numpy(tokens[None])
    if paged:
        logits, _, _ = lm.forward_prefill_chunk(
            lm._params, tok, p0, vlen, kc, vc, torch.from_numpy(where))
    else:
        logits, _, _ = lm.forward_verify(lm._params, tok, p0, vlen, kc, vc,
                                         where)
    tgt, n_acc, ok = tspec._verify_tail(logits, tok, vlen, req.seed, step0,
                                        req.temperature, req.top_k)
    return logits, tgt.tolist() + [int(n_acc), int(ok)]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_verify_from_its_buffers(backend, kv_dtype, lm, jlm, draft, jdraft,
                                 engines):
    paged = backend == "paged"
    kw = dict(num_slots=3, speculation_k=3, kv_dtype=kv_dtype)
    if paged:
        kw.update(PAGED, num_blocks=24)
    eng = engines(GenerationEngine, lm, draft_model=draft, **kw)
    je = engines(JaxEngine, jlm, draft_model=jdraft, **kw)
    rs = np.random.RandomState(4)
    jk = _seed_pools(eng._kcs, rs)
    jv = _seed_pools(eng._vcs, rs)
    vb, vlen, bs = eng._vbucket, 4, 8
    verify = (jspec.make_verify_paged_fn if paged
              else jspec.make_verify_slots_fn)(jlm)
    accepted = set()
    for trial in range(4):
        slot, req, step0 = int(rs.randint(3)), _req(rs), int(rs.randint(9))
        p0 = int(rs.randint(0, CFG["max_seq_len"] - vlen + 1))
        where = slot
        if paged:
            tbl = min(t for t in eng._tbl_buckets if t * bs >= p0 + vb)
            where = _paged_table(eng, rs, -(-(p0 + vb) // bs), tbl)
        tokens = rs.randint(VOCAB, size=vb).astype(np.int64)
        # drafts that follow the target's own samples for the first
        # ``trial % 4`` rows, so n_accepted takes several values
        for i in range(trial % 4):
            _, got = _verify_ref(lm, _clone(eng._kcs), _clone(eng._vcs),
                                 tokens, p0, vlen, where, req, step0, paged)
            tokens[i + 1] = got[i]
        kc, vc = _clone(eng._kcs), _clone(eng._vcs)
        logits, want = _verify_ref(lm, kc, vc, tokens, p0, vlen, where, req,
                                   step0, paged)
        eng._slots.step[slot] = step0
        name = "forward_prefill_chunk" if paged else "forward_verify"
        seen = _recorder(lm, name)
        try:
            got = eng._verify_call(slot, tokens, p0, req,
                                   where if paged else None)
        finally:
            delattr(lm, name)
        assert got == want
        accepted.add(got[vb])
        assert torch.equal(seen[0], logits)
        _same_bits(eng._kcs + eng._vcs, kc + vc)
        jtok = jnp.asarray(tokens[None], jnp.int32)
        jwhere = jnp.asarray(where) if paged else slot
        jl, _, _ = (jlm.forward_prefill_chunk(jlm._params, jtok, p0, vlen,
                                              jk, jv, jwhere) if paged else
                    jlm.forward_verify(jlm._params, jtok, p0, vlen, jk, jv,
                                       slot))
        _logits_near(seen[0].numpy(), np.asarray(jl), kv_dtype)
        jtgt, jn, jok, jk, jv = verify(jlm._params, jk, jv, jtok, p0, vlen,
                                       jwhere, req.seed, step0,
                                       req.temperature, req.top_k)
        assert np.asarray(jtgt).tolist() + [int(jn), int(jok)] == want
        _near_jax(eng._kcs + eng._vcs, jk + jv)
    assert len(accepted) >= 2


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("p0", [57, 59, 62])
def test_slot_verify_at_the_panel_end_writes_jax_panel(p0, kv_dtype, lm,
                                                      jlm, draft, engines):
    """k=4: an 8-row span from ``p0`` runs past the 64-position panel;
    the rows past it are not written (JAX's scatter drops them), with
    no host value: every other position keeps its bits."""
    eng = engines(GenerationEngine, lm, num_slots=2, speculation_k=4,
                  draft_model=draft, kv_dtype=kv_dtype)
    rs = np.random.RandomState(p0)
    jk = _seed_pools(eng._kcs, rs)
    jv = _seed_pools(eng._vcs, rs)
    before = _clone(eng._kcs + eng._vcs)
    vb = eng._vbucket
    assert p0 + vb > CFG["max_seq_len"]
    tokens = rs.randint(VOCAB, size=vb).astype(np.int64)
    req = types.SimpleNamespace(temperature=0.0, top_k=0, seed=1)
    eng._slots.step[1] = 3
    got = eng._verify_call(1, tokens, p0, req)
    jtgt, jn, jok, jk, jv = jspec.make_verify_slots_fn(jlm)(
        jlm._params, jk, jv, jnp.asarray(tokens[None], jnp.int32), p0, 5, 1,
        1, 3, 0.0, 0)
    assert got == np.asarray(jtgt).tolist() + [int(jn), int(jok)]
    _near_jax(eng._kcs + eng._vcs, jk + jv)
    for a, b in zip(eng._kcs + eng._vcs, before):
        a, b = tkv.kv_dequant_f32(a), tkv.kv_dequant_f32(b)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1, :, :p0],
                                                       b[1, :, :p0])
        assert not torch.equal(a[1, :, p0:], b[1, :, p0:])
