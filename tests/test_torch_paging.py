"""The port's paged-cache bookkeeping (``serving/paging.py``) against
the JAX package's: the same call sequences, made from a numpy seed,
give the same free lists, refcounts, tables, prefix-index matches, LRU
evictions, session displacements and ``chain_hashes`` bytes."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import paging as jp
from deeplearning4j_tpu_torch.serving import paging as tp


def _both(fn):
    """Run ``fn(module)`` on both packages; an exception must be the
    same type on both sides."""
    out = []
    for mod in (jp, tp):
        try:
            out.append(("ok", fn(mod)))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(("raise", type(e).__name__))
    assert out[0] == out[1], out
    return out[0]


def test_constants_and_helpers():
    assert tp.NULL_BLOCK == jp.NULL_BLOCK == 0
    for n in range(0, 70):
        for bs in (1, 3, 8, 16):
            assert tp.blocks_for(n, bs) == jp.blocks_for(n, bs)
    for n in range(1, 300):
        assert tp.pow2_bucket(n) == jp.pow2_bucket(n)
        for cap in (1, 8, 64):
            assert tp.pow2_bucket(n, cap=cap) == jp.pow2_bucket(n, cap=cap)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_random_sequence_matches(seed):
    rs = np.random.RandomState(seed)
    n_blocks = int(rs.randint(2, 24))
    a = {m: m.BlockAllocator(n_blocks) for m in (jp, tp)}
    held = []   # blocks with one reference we may drop, per the JAX side
    for _ in range(200):
        op = rs.randint(4)
        if op == 0:
            n = int(rs.randint(0, 6))
            got = _both(lambda m: a[m].alloc(n))
            if got[1]:
                held.extend(got[1])
        elif op == 1 and held:
            pick = [held[i] for i in rs.choice(len(held),
                                               rs.randint(1, 3))]
            _both(lambda m: a[m].share(pick))
            held.extend(pick)
        elif op == 2 and held:
            i = int(rs.randint(len(held)))
            b = held.pop(i)
            _both(lambda m: a[m].free([b]))
        else:
            # misuse raises on both sides and changes nothing
            bad = [int(rs.randint(0, n_blocks + 2))] * int(rs.randint(1, 4))
            _both(lambda m: a[m].free(bad) if not set(bad) <= set(held)
                  else None)
            _both(lambda m: a[m].share([jp.NULL_BLOCK]))
        assert a[tp]._free == a[jp]._free
        assert a[tp]._refs == a[jp]._refs
        assert a[tp].stats() == a[jp].stats()
        assert [a[tp].ref(b) for b in range(n_blocks)] == \
            [a[jp].ref(b) for b in range(n_blocks)]


def test_allocator_rejects_a_pool_of_only_the_null_block():
    _both(lambda m: m.BlockAllocator(1))


@pytest.mark.parametrize("blocks,n", [([4, 2, 9], 8), ([1], 1), ([], 4),
                                      ([3, 3], 2), ([5, 6, 7], 2)])
def test_block_table_matches(blocks, n):
    def go(m):
        t = m.BlockTable(blocks, block_size=8)
        return len(t), t.capacity_tokens, t.padded(n).tolist(), \
            str(t.padded(n).dtype)
    _both(go)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_pool_sizes_match(kv_dtype):
    shapes = [(2, 8, 4), (2, 8, 4), (4, 8, 2)]
    j = jp.PagedKVCache(shapes, num_blocks=10, kv_dtype=kv_dtype)
    t = tp.PagedKVCache(shapes, num_blocks=10, kv_dtype=kv_dtype,
                        device="cpu")
    assert t.nbytes() == j.nbytes()
    assert t.block_nbytes() == j.block_nbytes()
    assert t.bytes_per_token() == j.bytes_per_token()
    assert t.block_size == j.block_size == 8
    want = {"f32": torch.float32, "bf16": torch.bfloat16}[kv_dtype]
    for k, jk in zip(t.ks + t.vs, j.ks + j.vs):
        assert tuple(k.shape) == tuple(jk.shape)
        assert k.dtype == want and not k.any()


@pytest.mark.parametrize("seed", range(4))
def test_chain_hashes_same_bytes(seed):
    rs = np.random.RandomState(seed)
    for _ in range(20):
        toks = rs.randint(0, 32000, rs.randint(0, 70))
        bs = int(rs.choice([1, 4, 8, 16]))
        for arr in (toks, toks.astype(np.int64), toks.tolist()):
            assert tp.chain_hashes(arr, bs) == jp.chain_hashes(arr, bs)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_index_random_sequence_matches(seed):
    rs = np.random.RandomState(seed)
    cap = int(rs.randint(1, 6))
    idx = {m: m.PrefixIndex(capacity=cap) for m in (jp, tp)}
    prompts = [rs.randint(0, 5, 24) for _ in range(6)]
    for _ in range(120):
        op = rs.randint(5)
        hs = jp.chain_hashes(prompts[rs.randint(len(prompts))], 8)
        if op == 0:
            _both(lambda m: idx[m].match(hs))
        elif op == 1 and hs:
            i, b = int(rs.randint(len(hs))), int(rs.randint(1, 50))
            _both(lambda m: idx[m].register(hs[i], b))
        elif op == 2:
            _both(lambda m: idx[m].evict_lru())
        elif op == 3:
            _both(lambda m: idx[m].evict_over_capacity())
        elif rs.rand() < 0.1:
            _both(lambda m: sorted(idx[m].clear()))
        assert list(idx[tp].blocks()) == list(idx[jp].blocks())
        assert len(idx[tp]) == len(idx[jp])
    _both(lambda m: m.PrefixIndex(capacity=0))


@pytest.mark.parametrize("seed", range(4))
def test_session_store_random_sequence_matches(seed):
    rs = np.random.RandomState(seed)
    cap = int(rs.randint(1, 5))
    st = {m: m.SessionStore(capacity=cap) for m in (jp, tp)}
    ids = ["a", "b", "c", "d", "e", "f"]

    def sess(s):
        return None if s is None else (s.tokens.tolist(), s.blocks,
                                       s.session_id)
    for _ in range(120):
        op = rs.randint(4)
        sid = ids[rs.randint(len(ids))]
        if op == 0:
            toks = rs.randint(0, 9, rs.randint(1, 12))
            blocks = rs.randint(1, 30, rs.randint(1, 4)).tolist()
            _both(lambda m: [sess(s) for s in
                             st[m].put(sid, toks.copy(), list(blocks))])
        elif op == 1:
            _both(lambda m: sess(st[m].get(sid)))
        elif op == 2:
            _both(lambda m: sess(st[m].evict_lru()))
        elif rs.rand() < 0.1:
            _both(lambda m: [sess(s) for s in st[m].clear()])
        assert st[tp].ids() == st[jp].ids()
        assert [(b, n) for b, n in st[tp].iter_pins()] == \
            [(b, n) for b, n in st[jp].iter_pins()]
        assert (sid in st[tp]) == (sid in st[jp])
    _both(lambda m: m.SessionStore(capacity=0))
