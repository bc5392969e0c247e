"""Static-shape slot KV cache for continuous-batching decode
(counterpart of ``deeplearning4j_tpu/serving/kvcache.py``).

Per-layer ``[num_slots, n_heads, max_seq_len, head_dim]`` tensors are
allocated once; sequences claim and release slots while the shapes
never change. No zeroing between occupants: the next prefill
overwrites the prefix it will unmask and the per-slot length masks the
rest (the no-zeroing invariant, which is why the decode kernel never
reads past a slot's length). Prefill and decode write into these
tensors in place. An int8 cache holds int8 values and one f32 scale
per (slot, head, position).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.kv_quant import (canonical_kv_dtype, kv_bytes_per_token,
                                kv_nbytes, kv_scale_nbytes, kv_zero_,
                                kv_zeros)


class KVCache:
    """Per-layer K/V slot tensors on one device."""

    def __init__(self, layer_shapes: Sequence[Tuple[int, int, int]],
                 num_slots: int, kv_dtype: str = "f32", device=None):
        self.num_slots = int(num_slots)
        self.layer_shapes = [tuple(s) for s in layer_shapes]
        self.kv_dtype = canonical_kv_dtype(kv_dtype)
        self.ks: List = [kv_zeros((self.num_slots,) + s, self.kv_dtype,
                                  device) for s in self.layer_shapes]
        self.vs: List = [kv_zeros((self.num_slots,) + s, self.kv_dtype,
                                  device) for s in self.layer_shapes]

    def reset(self):
        """Zero every layer's K and V in place (int8 scale rows too),
        as a freshly allocated cache would hold: the fault ladder's
        recovery and poison rebuild on this instead of reallocating,
        so the decode step's CUDA graph, which captured these tensors'
        addresses, replays on the same storage and is never
        recaptured."""
        for pool in self.ks + self.vs:
            kv_zero_(pool)

    def nbytes(self) -> int:
        """Device bytes the cache pins (int8 scales included)."""
        return int(sum(2 * kv_nbytes((self.num_slots,) + s, self.kv_dtype)
                       for s in self.layer_shapes))

    def scale_nbytes(self) -> int:
        """Bytes of the f32 scales alone (0 unless int8)."""
        return int(sum(2 * kv_scale_nbytes((self.num_slots,) + s,
                                           self.kv_dtype)
                       for s in self.layer_shapes))

    def bytes_per_token(self) -> int:
        """K+V bytes one token position costs across all layers."""
        return kv_bytes_per_token(self.layer_shapes, self.kv_dtype)


class SlotTable:
    """Host-side slot bookkeeping: free-list allocation plus the dense
    per-slot arrays (current token, write position, sampling params)
    that feed each decode step. Inactive slots carry benign values
    (pos 0, temp 0); they ride the batch and their outputs are never
    read."""

    def __init__(self, num_slots: int):
        self.num_slots = int(num_slots)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self.requests: List[Optional[object]] = [None] * self.num_slots
        self.token = np.zeros(self.num_slots, np.int32)
        self.pos = np.zeros(self.num_slots, np.int32)
        self.step = np.zeros(self.num_slots, np.int32)
        self.seed = np.zeros(self.num_slots, np.uint32)
        self.temp = np.zeros(self.num_slots, np.float32)
        self.top_k = np.zeros(self.num_slots, np.int32)
        # per-lane termination: eos -1 = none (sampled tokens are >= 0);
        # max_steps is the request's max_tokens, 0 for inactive lanes
        self.eos = np.full(self.num_slots, -1, np.int32)
        self.max_steps = np.zeros(self.num_slots, np.int32)
        # speculative decoding (serving/speculative.py): a lane is
        # eligible once its draft is primed; cleared on free() and when
        # its draft fails (a draft fault never fails the request)
        self.spec_ok = np.zeros(self.num_slots, bool)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    def active_slots(self) -> List[int]:
        return [s for s in range(self.num_slots)
                if self.requests[s] is not None]

    def alloc(self, request) -> Optional[int]:
        """Claim a free slot for ``request`` (None when full)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.requests[slot] = request
        return slot

    def free(self, slot: int):
        """Release a slot. No cache zeroing (see the module doc)."""
        if self.requests[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.requests[slot] = None
        self.token[slot] = 0
        self.pos[slot] = 0
        self.step[slot] = 0
        self.seed[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.eos[slot] = -1
        self.max_steps[slot] = 0
        self.spec_ok[slot] = False
        self._free.append(slot)

    def commit(self, slot: int, token: int, n_accepted: int):
        """Settle a slot's cursors after a speculative round: advance
        pos and step by the ``n_accepted`` tokens it emitted, ``token``
        the last of them. A rejected tail needs no rollback: its K/V lies
        past the cursor, masked by every reader until an accepted write
        overwrites it (the no-zeroing invariant)."""
        if self.requests[slot] is None:
            raise ValueError(f"slot {slot} is free")
        if n_accepted < 1:
            raise ValueError(f"speculative round must commit >= 1 "
                             f"token, got {n_accepted}")
        self.token[slot] = token
        self.pos[slot] += n_accepted
        self.step[slot] += n_accepted
