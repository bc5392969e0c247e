"""Paged KV-cache memory manager: block-granular allocation for the
generation engine (counterpart of ``deeplearning4j_tpu/serving/
paging.py``; vLLM/PagedAttention, SOSP '23).

The slot cache (:mod:`.kvcache`) pins ``max_seq_len`` positions per
slot. Here the unit of allocation is a BLOCK of ``block_size``
positions inside one shared pool per layer::

    K, V : [num_blocks, n_heads, block_size, head_dim]

A sequence owns ceil((prompt + max_tokens) / block_size) blocks and a
block table maps its logical positions to pool blocks. The pool
tensors never change shape; which block belongs to whom is host-side
numpy bookkeeping, carried over line for line from the JAX package.

Invariants, shared with the slot cache:

- **No zeroing on reuse.** A freed block keeps its stale K/V; the next
  owner's writes overwrite what it uses and its length masks the rest.
- **Block 0 is the null block.** It is never allocated. Padded table
  entries point at it, so writes from padded lanes (inactive decode
  slots, the padded tail of a prefill chunk past an allocation) land
  where nobody reads, and the paged-attention kernel never reads past
  a sequence's length.
- **No over-commit.** :meth:`BlockAllocator.alloc` is all-or-nothing.
- **Shared blocks are immutable.** A block with more than one owner is
  never written in place: a writer gets a copy-on-write duplicate
  first (``GenerationEngine._cow``).

Prefix sharing layers per-block refcounts, a :class:`PrefixIndex` of
chained content hashes of full prompt blocks, and a
:class:`SessionStore` of finished turns pinned under a ``session_id``
on the allocator. The pools are written in place; the JAX executables
donated them. Block-run export and import for the host tier come with
the offload slice (ROADMAP.md queue A, item 8).
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.kv_quant import (canonical_kv_dtype, kv_bytes_per_token,
                                kv_nbytes, kv_scale_nbytes, kv_zero_,
                                kv_zeros)

#: Block index reserved as the write target of padded table entries.
#: Never handed out by the allocator.
NULL_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions."""
    return -(-int(tokens) // int(block_size))


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (>= 1), optionally clamped to
    ``cap``: the block-table padding rule that keeps the set of table
    shapes finite."""
    b = 1
    while b < max(int(n), 1):
        b <<= 1
    return b if cap is None else min(b, int(cap))


class BlockAllocator:
    """Free-list allocator over the pool's block indices.

    Block 0 (:data:`NULL_BLOCK`) is reserved; ``capacity`` counts only
    allocatable blocks. Allocation is all-or-nothing and LIFO, so a
    just-freed block is reused first. Blocks are refcounted:
    :meth:`alloc` sets each count to 1, :meth:`share` adds an owner,
    :meth:`free` drops one, and a block re-enters the free list only
    when its last owner releases it. ``used_count`` counts unique
    blocks."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        self._free = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        # mirror of _free for O(1) double-free checks on every retirement
        self._free_set = set(self._free)
        self._refs: Dict[int, int] = {}
        self.peak_used = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - len(self._free)

    @property
    def shared_count(self) -> int:
        """Unique blocks currently held by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    def ref(self, block: int) -> int:
        """Current refcount of ``block`` (0 if free)."""
        return self._refs.get(int(block), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks at refcount 1, or None (claim nothing)
        if fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(blocks)
        for b in blocks:
            self._refs[b] = 1
        self.peak_used = max(self.peak_used, self.used_count)
        return blocks

    def share(self, blocks: Sequence[int]):
        """Add one owner to each allocated block. Raises if any block
        is free: sharing never resurrects a block."""
        for b in blocks:
            b = int(b)
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"cannot share unallocated block {b}")
        for b in blocks:
            self._refs[int(b)] += 1

    def free(self, blocks: Sequence[int]):
        """Drop one owner per block; a block re-enters the free list
        only at refcount 0. The whole batch is validated before
        anything changes, so a bad call cannot half-free."""
        counted: Dict[int, int] = {}
        for b in blocks:
            b = int(b)
            if b == NULL_BLOCK or not 0 < b < self.num_blocks:
                raise ValueError(f"block {b} is not allocatable")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            counted[b] = counted.get(b, 0) + 1
            if counted[b] > self._refs.get(b, 0):
                raise ValueError(f"double free of block {b}")
        released = []
        for b in blocks:
            b = int(b)
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                released.append(b)
        self._free.extend(released)
        self._free_set.update(released)

    def stats(self) -> dict:
        return {"total": self.capacity, "free": self.free_count,
                "used": self.used_count, "peak_used": self.peak_used,
                "shared": self.shared_count}


class BlockTable:
    """One request's logical-position -> pool-block mapping (host-side
    int32). ``padded(n)`` emits the device-facing row, padded with
    :data:`NULL_BLOCK` to a caller-chosen length."""

    def __init__(self, blocks: Sequence[int], block_size: int):
        self.blocks = [int(b) for b in blocks]
        self.block_size = int(block_size)

    def __len__(self) -> int:
        return len(self.blocks)

    @property
    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.block_size

    def padded(self, n: int) -> np.ndarray:
        if n < len(self.blocks):
            raise ValueError(f"cannot pad {len(self.blocks)} blocks "
                             f"into a table of {n}")
        out = np.full(n, NULL_BLOCK, np.int32)
        out[:len(self.blocks)] = self.blocks
        return out


class PagedKVCache:
    """Per-layer pooled K/V blocks on one device, the paged sibling of
    :class:`~.kvcache.KVCache`. ``layer_shapes`` are per-layer
    ``(n_heads, block_size, head_dim)``, i.e.
    ``model.cache_shapes(block_size)``. f32, bf16 or int8 pools; an
    int8 pool has one f32 scale per (block, head, position)."""

    def __init__(self, layer_shapes: Sequence[Tuple[int, int, int]],
                 num_blocks: int, kv_dtype: str = "f32", device=None):
        self.num_blocks = int(num_blocks)
        self.layer_shapes = [tuple(s) for s in layer_shapes]
        self.block_size = int(self.layer_shapes[0][1])
        self.kv_dtype = canonical_kv_dtype(kv_dtype)
        self.ks: List = [kv_zeros((self.num_blocks,) + s, self.kv_dtype,
                                  device) for s in self.layer_shapes]
        self.vs: List = [kv_zeros((self.num_blocks,) + s, self.kv_dtype,
                                  device) for s in self.layer_shapes]

    def reset(self):
        """Zero every layer's K and V in place (int8 scale rows too),
        as a freshly allocated pool would hold: the fault ladder's
        recovery and poison rebuild on this instead of reallocating,
        so the decode step's CUDA graph, which captured these tensors'
        addresses, replays on the same storage and is never
        recaptured."""
        for pool in self.ks + self.vs:
            kv_zero_(pool)

    def nbytes(self) -> int:
        """Device bytes the pool pins (K+V, every layer, int8 scales
        included)."""
        return int(sum(2 * kv_nbytes((self.num_blocks,) + s,
                                     self.kv_dtype)
                       for s in self.layer_shapes))

    def block_nbytes(self) -> int:
        """Bytes one block pins across all layers (K+V, scales
        included)."""
        return self.nbytes() // self.num_blocks

    def scale_nbytes(self) -> int:
        """Bytes of the f32 scales alone (0 unless int8)."""
        return int(sum(2 * kv_scale_nbytes((self.num_blocks,) + s,
                                           self.kv_dtype)
                       for s in self.layer_shapes))

    def bytes_per_token(self) -> int:
        """K+V bytes one token position costs across all layers."""
        return kv_bytes_per_token(self.layer_shapes, self.kv_dtype)


def chain_hashes(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chained content hash per FULL block of ``tokens``:
    ``h_i = blake2b(h_{i-1} || tokens[i*Bs:(i+1)*Bs])`` over int32
    bytes, the same digests as the JAX package. Each digest identifies
    the block's content and its whole prefix; partial tail blocks are
    never hashed."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    bs = int(block_size)
    out: List[bytes] = []
    prev = b""
    for i in range(len(toks) // bs):
        h = hashlib.blake2b(prev + toks[i * bs:(i + 1) * bs].tobytes(),
                            digest_size=16).digest()
        out.append(h)
        prev = h
    return out


class PrefixIndex:
    """LRU map from chained block hash to pool block. The index owns
    one reference per registered block (the engine ``share()``s on
    register and ``free()``s on evict). Pure bookkeeping: methods
    return the blocks whose ownership changed and the caller settles
    refcounts on the scheduler thread."""

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def blocks(self) -> Iterator[int]:
        """All indexed blocks, eviction order first."""
        return iter(self._entries.values())

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest indexed chain prefix of ``hashes`` -> its blocks;
        matched entries are LRU-touched."""
        out: List[int] = []
        for h in hashes:
            b = self._entries.get(h)
            if b is None:
                break
            self._entries.move_to_end(h)
            out.append(b)
        return out

    def register(self, digest: bytes, block: int) -> bool:
        """Insert ``digest -> block``; True iff the entry is new (the
        caller then transfers a reference to the index). An existing
        entry is kept and LRU-touched."""
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return False
        self._entries[digest] = int(block)
        return True

    def evict_lru(self) -> Optional[int]:
        """Drop the least-recently-matched entry; returns its block
        (the caller frees the index's reference) or None when empty."""
        if not self._entries:
            return None
        _, block = self._entries.popitem(last=False)
        return block

    def evict_over_capacity(self) -> List[int]:
        """Evict LRU entries until within capacity; returns their
        blocks for the caller to free."""
        out: List[int] = []
        while len(self._entries) > self.capacity:
            out.append(self._entries.popitem(last=False)[1])
        return out

    def clear(self) -> List[int]:
        """Drop every entry; returns all previously indexed blocks."""
        out = list(self._entries.values())
        self._entries.clear()
        return out


class Session:
    """One pinned conversation: the K/V-valid token prefix (prompt +
    generated tokens whose K/V were written) and the blocks holding
    it."""
    __slots__ = ("tokens", "blocks", "session_id")

    def __init__(self, tokens: np.ndarray, blocks: List[int],
                 session_id: Optional[str] = None):
        self.tokens = tokens
        self.blocks = blocks
        self.session_id = session_id


class SessionStore:
    """LRU map ``session_id`` -> :class:`Session`: a finished turn's
    blocks stay pinned (the store owns one reference per block) so the
    next turn re-prefills only its new suffix. Pure bookkeeping, like
    :class:`PrefixIndex`: displaced sessions are returned and the
    caller frees their blocks."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._entries: "collections.OrderedDict[str, Session]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, session_id: str) -> bool:
        return session_id in self._entries

    def ids(self) -> List[str]:
        return list(self._entries.keys())

    def get(self, session_id: str) -> Optional[Session]:
        """LRU-touching lookup."""
        sess = self._entries.get(session_id)
        if sess is not None:
            self._entries.move_to_end(session_id)
        return sess

    def put(self, session_id: str, tokens: np.ndarray,
            blocks: List[int]) -> List[Session]:
        """Pin a finished turn, displacing the session's previous pin
        and LRU entries past capacity. Returns every displaced
        Session; the caller frees their blocks."""
        displaced: List[Session] = []
        old = self._entries.pop(session_id, None)
        if old is not None:
            displaced.append(old)
        self._entries[session_id] = Session(tokens, blocks, session_id)
        while len(self._entries) > self.capacity:
            displaced.append(self._entries.popitem(last=False)[1])
        return displaced

    def evict_lru(self) -> Optional[Session]:
        """Drop the least-recently-used session; the caller frees its
        blocks. None when empty."""
        if not self._entries:
            return None
        return self._entries.popitem(last=False)[1]

    def clear(self) -> List[Session]:
        out = list(self._entries.values())
        self._entries.clear()
        return out

    def iter_pins(self) -> Iterator[Tuple[List[int], int]]:
        """(blocks, n_valid_tokens) per live session."""
        for sess in self._entries.values():
            yield sess.blocks, len(sess.tokens)
