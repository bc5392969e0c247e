"""Hierarchical KV tier: host RAM and an optional disk ring below the
device block pool (counterpart of ``deeplearning4j_tpu/serving/
offload.py``, numpy only, carried over line for line but for
:meth:`HostBlockStore.stamp`).

The session store pins sessions IN the device pool, so live-session
capacity equals device pool bytes, though most users sit idle between
turns. Here evicted state demotes to a cheaper tier and restores on
demand instead of being discarded:

- :class:`HostRun`: one demoted block run, the token history plus
  per-layer contiguous numpy copies of the K and V pool rows AT THE
  POOL DTYPE (int8 values and their f32 scale rows travel together, so
  int8's byte saving carries into host bytes and PCIe traffic). numpy
  has no bfloat16: a bf16 pool's rows are kept as their 16-bit
  patterns (``uint16``) under ``kv_dtype="bf16"``, two bytes a value as
  in the JAX package, and viewed back to ``torch.bfloat16`` on restore
  (``kernels/kv_quant.py``: ``kv_pack_host``, ``kv_unpack_host``).
- :class:`DiskRing`: the optional third tier, a fixed-size mmap'd ring
  file. Writes append; an entry the cursor overruns is evicted (the
  oldest bytes die first). Reads rebuild a :class:`HostRun`.
- :class:`HostBlockStore`: LRU and byte budget over both tiers.
  ``put`` inserts into RAM and spills LRU runs over budget to the disk
  ring (or drops them when there is none). Thread-safe: the scheduler
  thread demotes and restores while the prefetch thread stages reads.
- :class:`OffloadPrefetcher`: one daemon thread that overlaps the slow
  half of a restore (a disk read and the padded scatter operands) with
  the request's queue wait. The engine ``request()``s a stage at
  submit time and ``take()``s the staged operands at admission; the
  allocator and every device call stay on the scheduler thread, and
  the prefetcher touches host memory only.

This module never sees a device tensor, an allocator or a CUDA graph:
it stores bytes and token arrays. The engine (:mod:`.generation`) owns
the device halves (the gather and scatter graphs per power-of-two run
bucket, demote-on-evict, the restore-or-re-prefill decision) and the
``offload_io`` fault seam: a torn demotion drops the host copy, a torn
restore falls back to a clean re-prefill, and tier IO never corrupts a
lane.
"""
from __future__ import annotations

import collections
import os
import queue
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HostRun:
    """One demoted block run: ``tokens`` (the K/V-valid token history,
    int32 copy) plus per-layer packed K and V rows as produced by
    :func:`~deeplearning4j_tpu_torch.kernels.kv_quant.kv_pack_host` —
    each layer a tuple of contiguous numpy arrays (``(values,)`` for
    f32 pools, ``(bits,)`` in ``uint16`` for bf16, ``(q, scale)`` for
    int8). ``nbytes`` is the host footprint the byte budget charges."""

    __slots__ = ("tokens", "ks", "vs", "n_blocks", "kv_dtype", "nbytes")

    def __init__(self, tokens: np.ndarray,
                 ks: Sequence[Tuple[np.ndarray, ...]],
                 vs: Sequence[Tuple[np.ndarray, ...]],
                 kv_dtype: str):
        self.tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        self.ks = tuple(tuple(p for p in layer) for layer in ks)
        self.vs = tuple(tuple(p for p in layer) for layer in vs)
        self.n_blocks = int(self.ks[0][0].shape[0])
        self.kv_dtype = str(kv_dtype)
        self.nbytes = int(self.tokens.nbytes
                          + sum(p.nbytes for layer in self.ks
                                for p in layer)
                          + sum(p.nbytes for layer in self.vs
                                for p in layer))

    # ---------------------------------------------- disk serialization

    def pack(self) -> Tuple[bytes, dict]:
        """Flatten to (payload bytes, meta dict) for the disk ring.
        Meta holds every shape/dtype so :meth:`unpack` needs no pickle
        — plain concatenated buffers, self-describing and compact."""
        parts: List[np.ndarray] = [self.tokens]
        for layer in self.ks:
            parts.extend(layer)
        for layer in self.vs:
            parts.extend(layer)
        meta = {
            "kv_dtype": self.kv_dtype,
            "n_blocks": self.n_blocks,
            "k_layers": [[(p.shape, str(p.dtype)) for p in layer]
                         for layer in self.ks],
            "v_layers": [[(p.shape, str(p.dtype)) for p in layer]
                         for layer in self.vs],
            "n_tokens": int(self.tokens.shape[0]),
        }
        return b"".join(np.ascontiguousarray(p).tobytes()
                        for p in parts), meta

    @classmethod
    def unpack(cls, buf: memoryview, meta: dict) -> "HostRun":
        off = 0

        def take(shape, dtype):
            nonlocal off
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            arr = np.frombuffer(buf[off:off + n],
                                dtype=dtype).reshape(shape).copy()
            off += n
            return arr

        tokens = take((meta["n_tokens"],), np.int32)
        ks = [tuple(take(s, d) for s, d in layer)
              for layer in meta["k_layers"]]
        vs = [tuple(take(s, d) for s, d in layer)
              for layer in meta["v_layers"]]
        return cls(tokens, ks, vs, meta["kv_dtype"])


class DiskRing:
    """Fixed-capacity mmap'd ring file: the third KV tier.

    Entries are appended at a rolling cursor; when an entry would
    overrun the remaining tail, the cursor wraps to 0. Any stored
    entry whose bytes overlap the incoming write is evicted first —
    classic ring semantics, the oldest bytes on disk die to make room.
    An entry larger than the whole ring is rejected (returns False).

    The file is created lazily (a tempfile when no ``path`` is given)
    and unlinked on :meth:`close`. All coordination is the caller's
    (:class:`HostBlockStore` holds the lock)."""

    def __init__(self, capacity_bytes: int, path: Optional[str] = None):
        self.capacity = int(capacity_bytes)
        if self.capacity < 1:
            raise ValueError("disk ring capacity must be >= 1 byte, "
                             f"got {capacity_bytes}")
        self._path = path
        self._own_file = path is None
        self._mm: Optional[np.memmap] = None
        self._cursor = 0
        # key -> (offset, length, meta); insertion order == write order
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()

    def _ensure_open(self) -> np.memmap:
        if self._mm is None:
            if self._path is None:
                fd, self._path = tempfile.mkstemp(prefix="kv_ring_",
                                                  suffix=".bin")
                os.close(fd)
            self._mm = np.memmap(self._path, dtype=np.uint8, mode="w+",
                                 shape=(self.capacity,))
        return self._mm

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def used_bytes(self) -> int:
        return sum(length for _, length, _ in self._entries.values())

    def _evict_range(self, start: int, end: int):
        doomed = [k for k, (off, length, _) in self._entries.items()
                  if off < end and off + length > start]
        for k in doomed:
            del self._entries[k]

    def put(self, key: str, payload: bytes, meta: dict) -> bool:
        """Write one entry, evicting whatever the ring overwrites.
        False iff the payload cannot fit the ring at all."""
        n = len(payload)
        if n > self.capacity:
            return False
        mm = self._ensure_open()
        self._entries.pop(key, None)
        if self._cursor + n > self.capacity:
            # wrapping: the abandoned tail's entries die too
            self._evict_range(self._cursor, self.capacity)
            self._cursor = 0
        start = self._cursor
        self._evict_range(start, start + n)
        mm[start:start + n] = np.frombuffer(payload, np.uint8)
        self._cursor = start + n
        self._entries[key] = (start, n, meta)
        return True

    def get(self, key: str) -> Optional[HostRun]:
        ent = self._entries.get(key)
        if ent is None:
            return None
        off, length, meta = ent
        mm = self._ensure_open()
        return HostRun.unpack(memoryview(mm)[off:off + length], meta)

    def pop(self, key: str):
        self._entries.pop(key, None)

    def clear(self):
        self._entries.clear()
        self._cursor = 0

    def close(self):
        self._entries.clear()
        if self._mm is not None:
            del self._mm
            self._mm = None
        if self._own_file and self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None


class HostBlockStore:
    """LRU + byte-budget map ``key -> HostRun`` over host RAM with an
    optional :class:`DiskRing` below it.

    ``put`` inserts into RAM, then while RAM is over ``byte_budget``
    the LRU run spills to the disk ring (or is dropped when there is
    none / it will not fit). ``get`` checks RAM then disk; a disk hit
    is NOT promoted back to RAM (the caller is about to scatter it to
    the device anyway — promotion would only churn the budget).
    ``pop`` removes from both tiers. ``stamp`` names the put that stored
    a key's current run, in RAM or on disk (the JAX store has no stamp:
    its ``peek`` identity check sees RAM only, so a run staged by the
    prefetcher and spilled since counted as stale there).

    Thread-safe: one lock serializes the scheduler thread's demotes/
    restores against the prefetch thread's staged reads."""

    def __init__(self, byte_budget: int,
                 disk: Optional[DiskRing] = None):
        self.byte_budget = int(byte_budget)
        if self.byte_budget < 1:
            raise ValueError("host byte budget must be >= 1, got "
                             f"{byte_budget}")
        self.disk = disk
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, HostRun]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._stamps: Dict[str, int] = {}  # key -> the put that stored it
        self._puts = 0
        # counters surfaced through the engine's offload gauges
        self.spills = 0        # RAM -> disk demotions
        self.drops = 0         # runs lost at the bottom of the hierarchy

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            if key in self._entries:
                return True
            return self.disk is not None and key in self.disk

    def put(self, key: str, run: HostRun):
        """Insert (replacing any same-key entry in either tier), then
        enforce the byte budget by spilling LRU runs down a tier."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            if self.disk is not None:
                self.disk.pop(key)
            self._entries[key] = run
            self._bytes += run.nbytes
            self._puts += 1
            self._stamps[key] = self._puts
            # the just-inserted run is never evicted even when it alone
            # exceeds the budget (len > 1 guard): an oversized demotion
            # degrading to a silent discard would break zero-re-prefill
            while self._bytes > self.byte_budget and len(self._entries) > 1:
                lru_key, lru_run = self._entries.popitem(last=False)
                self._bytes -= lru_run.nbytes
                spilled = False
                if self.disk is not None:
                    payload, meta = lru_run.pack()
                    spilled = self.disk.put(lru_key, payload, meta)
                if spilled:
                    self.spills += 1
                else:
                    self.drops += 1
                    self._stamps.pop(lru_key, None)

    def get(self, key: str) -> Optional[HostRun]:
        """RAM first (LRU-touching), then disk. None on full miss."""
        with self._lock:
            run = self._entries.get(key)
            if run is not None:
                self._entries.move_to_end(key)
                return run
            if self.disk is not None:
                return self.disk.get(key)
            return None

    def peek(self, key: str) -> Optional[HostRun]:
        """RAM-tier lookup WITHOUT LRU touch or disk read — identity
        checks (is this staged run still current?) must not pay a disk
        read or perturb eviction order."""
        with self._lock:
            return self._entries.get(key)

    def stamp(self, key: str) -> Optional[int]:
        """The number of the put that stored ``key``'s current run (RAM
        or disk), None when neither tier holds it: a run staged under
        this stamp is still current, wherever it lives now, and no disk
        read is paid to tell."""
        with self._lock:
            if key in self._entries or (self.disk is not None
                                        and key in self.disk):
                return self._stamps.get(key)
            self._stamps.pop(key, None)
            return None

    def pop(self, key: str):
        """Remove ``key`` from both tiers (after a successful restore,
        or to invalidate a torn copy)."""
        with self._lock:
            self._stamps.pop(key, None)
            run = self._entries.pop(key, None)
            if run is not None:
                self._bytes -= run.nbytes
            if self.disk is not None:
                self.disk.pop(key)

    def keys(self) -> List[str]:
        with self._lock:
            out = list(self._entries.keys())
            if self.disk is not None:
                out.extend(k for k in self.disk._entries
                           if k not in self._entries)
            return out

    def stats(self) -> dict:
        with self._lock:
            host_blocks = sum(r.n_blocks for r in self._entries.values())
            out = {"host_runs": len(self._entries),
                   "host_blocks": host_blocks,
                   "host_bytes": self._bytes,
                   "spills": self.spills,
                   "drops": self.drops,
                   "disk_blocks": 0, "disk_bytes": 0}
            if self.disk is not None:
                out["disk_blocks"] = sum(
                    int(m.get("n_blocks", 0))
                    for _, _, m in self.disk._entries.values())
                out["disk_bytes"] = self.disk.used_bytes
            return out

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._stamps.clear()
            self._bytes = 0
            if self.disk is not None:
                self.disk.clear()

    def close(self):
        self.clear()
        if self.disk is not None:
            self.disk.close()


class OffloadPrefetcher:
    """One daemon thread that runs ``stage_fn(key)`` ahead of need and
    parks the result until the scheduler ``take()``s it.

    ``stage_fn`` must touch HOST state only (store read — possibly a
    disk read — plus padded scatter-operand construction): the
    allocator and all device calls stay on the scheduler thread, so a
    prefetch can never race engine state. Staged results are capped at
    ``max_staged``; when full, new requests stage lazily at admission
    instead (correct, just not overlapped)."""

    def __init__(self, stage_fn: Callable[[str], object],
                 max_staged: int = 64):
        self._stage_fn = stage_fn
        self.max_staged = int(max_staged)
        self._lock = threading.Lock()
        self._staged: Dict[str, object] = {}
        self._inflight: set = set()
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="kv-offload-prefetch",
                                        daemon=True)
        self._thread.start()

    def request(self, key: str):
        """Ask for ``key`` to be staged. Deduplicates against both
        in-flight and already-staged work; silently drops when the
        staging buffer is full (admission will stage inline)."""
        with self._lock:
            if not self._running:
                return
            if key in self._staged or key in self._inflight:
                return
            if len(self._staged) + len(self._inflight) >= self.max_staged:
                return
            self._inflight.add(key)
        self._q.put(key)

    def take(self, key: str):
        """Pop the staged result for ``key`` (None if not staged —
        not requested, still in flight, or the stage failed)."""
        with self._lock:
            return self._staged.pop(key, None)

    def discard(self, key: str):
        """Drop any staged result for ``key`` (it went stale)."""
        with self._lock:
            self._staged.pop(key, None)

    def _loop(self):
        while True:
            key = self._q.get()
            if key is None:
                return
            try:
                result = self._stage_fn(key)
            except Exception:
                # staging is best-effort: a failed stage falls back to
                # the inline path at admission
                result = None
            with self._lock:
                self._inflight.discard(key)
                if result is not None and self._running:
                    self._staged[key] = result

    def stop(self):
        with self._lock:
            self._running = False
            self._staged.clear()
        self._q.put(None)
        self._thread.join(timeout=5.0)
