"""Continuous-batching autoregressive generation (counterpart of
``deeplearning4j_tpu/serving/generation.py``: the slot and paged
backends and the pipelined decode loop).

Iteration-level scheduling (Orca, OSDI '22): every loop iteration the
scheduler

1. admits queued requests. On the slot backend (``cache="slots"``)
   each gets a cache slot and one prefill at its power-of-two prompt
   bucket (the flash kernel on the card). On the paged backend
   (``cache="paged"``) each claims a slot and its worst-case count of
   pool blocks, all or nothing, after matching its prompt against the
   prefix index and its session (matched blocks are shared by
   refcount, a mid-block match tail is copied on write); one prefill
   CHUNK of one admitted request then runs per iteration (Sarathi-
   Serve), in plain PyTorch,
2. decodes ONE token for every decode-ready slot in a single batched
   step (the decode-attention kernel over slots, the paged-attention
   kernel over the block pool),
3. samples per slot (greedy / temperature / top-k, one uniform per
   request and step from ``fold_in(PRNGKey(seed), step)``, bit-identical
   to ``jax.random``, so results do not depend on slot or schedule),
4. retires sequences on EOS or ``max_tokens`` and frees their slots.

With ``decode_pipeline`` (the default, as in the JAX engine) step t+1
is dispatched before step t's tokens are synced, so emit, retire and
admit overlap the device: a continuing lane's token is fed from the
previous step's device output, and every device call runs on the one
current stream, so a freed slot's or block's next writer is ordered
after the in-flight step that still reads it. On the card the decode
step (embedding, the layers with their in-place K/V writes, the
attention kernel, the finite-logits guard, sampling and the done
flags) is one CUDA graph per engine, captured at :meth:`warmup` (the
torch form of the JAX engine's one AOT decode executable) and replayed
every step; ``metrics.compiles`` counts captures.

Overload semantics match the JAX engine: a bounded queue sheds (503,
:class:`QueueFullError`), batch-priority work is shed first, and
deadlines (504, :class:`DeadlineExceededError`) are enforced at
submission (from measured prefill/decode costs), in the queue and
mid-generation. A lane whose logits go non-finite is quarantined alone
(:class:`PoisonRequestError`).

The loop is supervised as the JAX engine's is (the fault ladder):

- a :class:`TransientFault` (raised before any device state changed)
  retries the iteration with exponential backoff, up to
  ``max_step_retries`` consecutive strikes;
- exhausted strikes, a :class:`CorruptedStateFault` or any other
  exception (a kernel or launch error) trigger recompute-recovery: the
  in-flight decode steps are dropped, the KV cache is zeroed IN PLACE
  (the decode step's CUDA graph holds its addresses and is never
  recaptured), and every in-flight request is re-admitted ahead of the
  queue and re-prefilled from its prompt plus the tokens it already
  emitted, resuming at the PRNG fold a fault-free run would use, so its
  tokens are those of a fault-free run. A request that rides
  ``max_recoveries_per_request`` recoveries, or outlives its deadline,
  fails alone;
- a recovery that raises poisons the engine: every in-flight request
  fails with :class:`ServingError` and the cache is zeroed again. A
  CUDA error that persists (an illegal address makes every later call
  raise) makes that raise too, and the scheduler thread ends:
  :meth:`alive` then reports False.

A prefill call that raises fails only its own request and recovers
the others. Prefill, decode and copy-on-write write the KV cache in
place; the JAX executables donated it.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import random as jrandom
from ..faults import (CorruptedStateFault, PoisonRequestError,
                      TransientFault, poll_until_idle)
from ..kernels import add_launches, launch_counts
from ..kernels.kv_quant import (canonical_kv_dtype, kv_copy_row,
                                kv_update_slice)
from ..profiler import OpProfiler
from .batcher import (PRIORITIES, DeadlineExceededError, DrainingError,
                      QueueFullError)
from .engine import ClientError, ServingError
from .kvcache import KVCache, SlotTable
from .metrics import GenerationMetrics
from .paging import (NULL_BLOCK, BlockAllocator, BlockTable, PagedKVCache,
                     PrefixIndex, SessionStore, blocks_for, chain_hashes,
                     pow2_bucket)

_NEG_INF = -1e30

#: static cap on per-request top_k (the filter thresholds against
#: ``topk(logits, cap)``); top_k >= vocab means no filter
TOP_K_CAP = 128

#: the int32 rows of the decode step's input buffer, one entry per lane
#: each (temp and uniform hold f32 bits); the paged tables follow
_IN_ROWS = ("tok_host", "use_host", "pos", "top_k", "eos", "step",
            "max_steps", "temp", "uniform")


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"queue A, item {item})")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _sample_from_logits(logits, temps, top_ks, us):
    """Greedy (temp <= 0) / temperature / top-k sampling over rows:
    inverse-CDF with one pre-drawn uniform per row, ``top_ks <= 0``
    disabling the filter. The shared core of prefill and decode, as in
    the JAX engine."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)  # first index of the max
    cap = min(TOP_K_CAP, vocab)
    desc = torch.topk(logits, cap, dim=-1).values               # [S, cap]
    kth = desc.gather(1, (top_ks - 1).clamp(0, cap - 1)[:, None])
    filt = torch.where((top_ks[:, None] > 0) & (top_ks[:, None] < vocab)
                       & (logits < kth), _NEG_INF, logits)
    p = torch.softmax(filt / temps.clamp_min(1e-6)[:, None], dim=-1)
    c = torch.cumsum(p, dim=-1)
    # c[:, -1] instead of 1: the cumulative sum may drift below 1
    sampled = torch.argmax((c > (us * c[:, -1])[:, None]).to(torch.int32),
                           dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _uniforms(seeds: np.ndarray, steps: np.ndarray) -> torch.Tensor:
    """One uniform per row from ``fold_in(PRNGKey(seed), step)``, on the
    CPU, bit-identical to the JAX engine's draws."""
    key = jrandom.fold_in(
        jrandom.PRNGKey(torch.from_numpy(seeds.astype(np.int64))),
        torch.from_numpy(steps.astype(np.int64)))
    return jrandom.uniform(key)


# ---------------------------------------------------------------------------
# request
# ---------------------------------------------------------------------------
def _recovery_seq(req: "_GenRequest") -> np.ndarray:
    """The K/V-valid prefix of a request: the prompt plus the emitted
    tokens minus the last one, whose K/V the next decode step writes.
    A recovered request re-prefills exactly this, and a finished
    session turn pins it."""
    if req.tokens:
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], req.prompt.dtype)])
    return req.prompt


class _GenRequest:
    __slots__ = ("prompt", "max_tokens", "temperature", "top_k", "seed",
                 "eos_id", "deadline", "priority", "session_id", "event",
                 "tokens", "error", "finish_reason", "stream_q", "t_submit",
                 "t_first", "t_last", "abandoned", "recoveries", "_lock",
                 "_timeout_counted")

    def __init__(self, prompt, max_tokens, temperature, top_k, seed,
                 eos_id, deadline, stream: bool,
                 priority: str = "interactive",
                 session_id: Optional[str] = None):
        self.prompt = prompt
        self.session_id = session_id
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.eos_id = eos_id
        self.deadline = deadline
        self.priority = priority
        self.event = threading.Event()
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        # unbounded: admission is already bounded by the queue and the
        # slot count, and the scheduler must never block on a slow
        # streaming consumer
        self.stream_q: Optional["queue.Queue"] = (
            queue.Queue() if stream else None)
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.abandoned = False  # submitter gave up: skip, don't recount
        self.recoveries = 0     # recompute-recovery re-admissions
        self._lock = threading.Lock()
        self._timeout_counted = False

    def count_timeout_once(self, metrics) -> None:
        """The waiter and the scheduler can both see the deadline pass;
        the timeouts counter moves once per request."""
        with self._lock:
            if self._timeout_counted:
                return
            self._timeout_counted = True
        metrics.inc("timeouts")

    def result(self) -> Dict[str, Any]:
        return {"tokens": list(self.tokens),
                "prompt_tokens": len(self.prompt),
                "finish_reason": self.finish_reason}


class _TokenStream:
    """Iterator over one streaming generation. ``close()`` (explicit,
    or from GC) abandons an unfinished request so the scheduler frees
    its slot, even if iteration never started."""

    def __init__(self, engine: "GenerationEngine", req: _GenRequest):
        self._engine = engine
        self._req = req
        self._i = 0
        self._done = False

    def __iter__(self) -> "Iterator[Dict]":
        return self

    def __next__(self) -> Dict:
        if self._done:
            raise StopIteration
        req = self._req
        budget = req.deadline - time.perf_counter() + 1.0
        try:
            kind, payload = req.stream_q.get(timeout=max(budget, 0.001))
        except queue.Empty:
            self._done = True
            req.abandoned = True
            req.count_timeout_once(self._engine.metrics)
            raise DeadlineExceededError("stream stalled past the "
                                        "deadline")
        if kind == "token":
            i = self._i
            self._i += 1
            return {"token": int(payload), "index": i}
        self._done = True
        if kind == "done":
            self._engine.metrics.inc("responses")
            final = req.result()
            final["done"] = True
            return final
        raise payload  # "error"

    def close(self):
        if not self._done and self._req.finish_reason is None \
                and self._req.error is None:
            self._req.abandoned = True  # the scheduler frees the slot
        self._done = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from GC
            pass


class _ChunkState:
    """One request mid-prefill on the paged backend: its slot, block
    table, table bucket, the sequence it prefills (the prompt, or after
    a recovery :func:`_recovery_seq`) and its chunk plan with a cursor.
    ``start`` is the prefix-cache match length: positions below it
    already hold valid K/V, so the plan begins there and
    ``done_tokens`` counts them as live from admission on."""

    __slots__ = ("req", "slot", "table", "tbl_bucket", "plan", "idx",
                 "seq", "start")

    def __init__(self, req: _GenRequest, slot: int, table: BlockTable,
                 tbl_bucket: int, plan: List[Tuple[int, int, int]],
                 seq: np.ndarray, start: int = 0):
        self.req = req
        self.slot = slot
        self.table = table
        self.tbl_bucket = tbl_bucket
        self.plan = plan                  # [(p0, chunk bucket, len)]
        self.idx = 0
        self.seq = seq
        self.start = start

    @property
    def done_tokens(self) -> int:
        return self.plan[self.idx - 1][0] + self.plan[self.idx - 1][2] \
            if self.idx else self.start


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class GenerationEngine:
    """Continuous-batching decode engine over a
    :class:`~deeplearning4j_tpu_torch.zoo.transformer_lm.CausalTransformerLM`
    (or any model with its ``forward_prefill`` / ``forward_decode`` /
    ``forward_prefill_chunk`` / ``forward_decode_paged`` /
    ``cache_shapes`` surface), on the model's device.

    ``num_slots`` bounds concurrent sequences (the batch of every
    decode step); ``max_seq_len`` bounds prompt + generated tokens.

    - ``cache="slots"`` (default): dense per-slot panels
      ``[num_slots, H, max_seq_len, Dh]``.
    - ``cache="paged"``: a shared block pool ``[num_blocks, H,
      block_size, Dh]`` (``serving/paging.py``). A request claims
      ``ceil((prompt + max_tokens) / block_size)`` blocks at admission,
      all or nothing, and waits at the queue head when they run out.
      Prefill runs in chunks of at most ``prefill_chunk_tokens``
      interleaved with decode steps. With ``enable_prefix_sharing``
      (default on) admission matches the prompt against an LRU index of
      chained-hashed full prompt blocks and against ``session_id``-
      pinned turns; matched blocks join the request's table by
      refcount and a mid-block match tail is copied on write. Tokens
      are identical to the slot backend's.
    - ``kv_dtype``: ``"f32"`` (default), ``"bf16"`` or ``"int8"`` for
      either backend. An int8 cache stores int8 values with one f32
      scale per (head, position), quantized on every write and
      dequantized inside the int8 attention kernels; copy-on-write
      copies the scale rows with the values.

    - ``decode_pipeline`` (default on, as in the JAX engine): step t+1
      is dispatched before step t's tokens are synced; ``False`` syncs
      every step. Tokens are identical either way.
    - ``decode_impl``: ``"auto"``, the one decode-attention dispatch of
      the port (the kernel on the card, its plain version on the CPU);
      any other name raises ``ValueError``.
    - the fault ladder (see the module doc): ``fault_injector`` (a
      :class:`~deeplearning4j_tpu_torch.faults.FaultInjector`, or
      :meth:`set_fault_injector` later), ``max_step_retries``,
      ``retry_backoff_ms`` doubling up to ``retry_backoff_max_ms``,
      ``max_recoveries_per_request`` and ``stall_timeout_s`` (the
      heartbeat age past which :meth:`alive` reports a wedged loop).

    The parameters take the JAX engine's positions and defaults.
    Speculative decoding (``speculation_k``, ``draft_model``) and the
    offload tiers (``offload_*``) are not ported yet: off their JAX
    defaults they raise ``NotImplementedError`` naming their ROADMAP.md
    item.
    """

    def __init__(self, model, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 min_prompt_bucket: int = 8,
                 max_queue: int = 256,
                 default_timeout_ms: float = 60_000.0,
                 decode_impl: str = "auto",
                 cache: str = "slots",
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 enable_prefix_sharing: bool = True,
                 prefix_index_capacity: int = 1024,
                 session_capacity: int = 64,
                 metrics: Optional[GenerationMetrics] = None,
                 fault_injector=None,
                 max_step_retries: int = 3,
                 retry_backoff_ms: float = 1.0,
                 retry_backoff_max_ms: float = 50.0,
                 max_recoveries_per_request: int = 3,
                 stall_timeout_s: float = 30.0,
                 batch_queue_fraction: float = 0.5,
                 speculation_k: int = 0,
                 draft_model=None,
                 decode_pipeline: bool = True,
                 kv_dtype: str = "f32",
                 offload_host_bytes: int = 0,
                 offload_disk_bytes: int = 0,
                 offload_dir: Optional[str] = None,
                 offload_prefetch: bool = True):
        if cache not in ("slots", "paged"):
            raise ValueError(f"cache must be 'slots' or 'paged', "
                             f"got {cache!r}")
        self.cache_backend = cache
        if decode_impl != "auto":
            raise ValueError(f"decode_impl must be 'auto' (the port's one "
                             f"decode-attention dispatch), got "
                             f"{decode_impl!r}")
        self.decode_impl = decode_impl
        self.kv_dtype = canonical_kv_dtype(kv_dtype)
        if int(speculation_k) or draft_model is not None:
            raise _todo("speculative decoding (speculation_k > 0)", "7")
        if int(offload_host_bytes):
            raise _todo("the host KV tier (offload_host_bytes > 0)", "8")
        if int(offload_disk_bytes) or offload_dir is not None \
                or not offload_prefetch:
            raise _todo("the disk KV tier and its prefetch (offload_disk_"
                        "bytes, offload_dir, offload_prefetch)", "8")
        if getattr(model, "_params", None) is None:
            model.init()
        self.model = model
        self.device = model.device
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.max_seq_len = int(max_seq_len or model.max_seq_len)
        if self.max_seq_len < 2:
            raise ValueError("max_seq_len must be >= 2 (one prompt "
                             "token + one generated token)")
        if self.max_seq_len > model.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"position table ({model.max_seq_len})")
        self.default_timeout_ms = float(default_timeout_ms)
        self.min_prompt_bucket = int(min_prompt_bucket)
        if prompt_buckets is None:
            prompt_buckets = []
            b = self.min_prompt_bucket
            while b < self.max_seq_len:
                prompt_buckets.append(b)
                b <<= 1
        # max_seq_len is always a bucket, so every admissible prompt
        # (<= max_seq_len - 1) has a home
        self.prompt_buckets = sorted(
            set(int(b) for b in prompt_buckets) | {self.max_seq_len})
        if self.prompt_buckets[0] < 1 or \
                self.prompt_buckets[-1] > self.max_seq_len:
            raise ValueError(f"prompt_buckets {self.prompt_buckets} "
                             f"outside [1, max_seq_len]")
        self.enable_prefix_sharing = False
        self.prefill_chunk_tokens = None
        if cache == "paged":
            self._init_paged(block_size, num_blocks, prefill_chunk_tokens,
                             enable_prefix_sharing, prefix_index_capacity,
                             session_capacity)
        self.metrics = metrics or GenerationMetrics()
        self.metrics.queue_max = int(max_queue)
        self.metrics.num_slots = self.num_slots
        self.metrics.cache_backend = self.cache_backend
        self._cache = self._fresh_cache()
        self.metrics.cache_bytes = self._cache.nbytes()
        self.metrics.kv_dtype = self.kv_dtype
        self.metrics.kv_bits = {"f32": 32, "bf16": 16, "int8": 8}[
            self.kv_dtype]
        self.metrics.kv_bytes_per_token = self._cache.bytes_per_token()
        self.metrics.quant_scale_bytes = self._cache.scale_nbytes()
        self._kcs = self._cache.ks
        self._vcs = self._cache.vs
        self._slots = SlotTable(self.num_slots)
        # -- the decode step's device buffers (static, so one CUDA graph
        # replays them): int32 inputs (rows of _IN_ROWS, then the paged
        # tables) and int64 outputs [next token, logits finite, done]
        S = self.num_slots
        n_in = len(_IN_ROWS) * S
        if cache == "paged":
            n_in += S * self._blocks_per_seq
        self._step_in = torch.zeros(n_in, dtype=torch.int32,
                                    device=self.device)
        self._step_out = torch.zeros((3, S), dtype=torch.int64,
                                     device=self.device)
        # -- pipelined decode: with it on, the loop dispatches step t+1
        # before collecting step t (the JAX engine's default; the knob
        # exists for A/B identity tests)
        self.decode_pipeline = bool(decode_pipeline)
        # in-flight decode steps, oldest first (at most 2)
        self._pending: "collections.deque" = collections.deque()
        # lanes whose current token lives only on the device (the last
        # dispatched step's output); prefill refreshes the host mirror
        self._tok_on_dev = np.zeros(S, bool)
        # the decode step as a CUDA graph (card only, captured at warmup
        # or on the first decode step after a hot one); replays add
        # _graph_launches to the kernels' launch counters. Set
        # _cuda_graph False before warmup for the eager step (A/B runs)
        self._cuda_graph = self.device.type == "cuda"
        self._graph = None
        self._graph_launches: Dict[str, int] = {}
        if cache == "paged":
            self.metrics.block_size = self.block_size
            self.metrics.blocks_total = self._allocator.capacity
            self.metrics.prefix_sharing = self.enable_prefix_sharing
            self._update_block_gauges()
        self._profiler = OpProfiler.get_instance()
        # cost-aware admission: EWMAs of measured prefill ms per padded
        # prompt token and decode ms per step (0.0 until measured, so
        # a cold engine admits everything). A bucket's first call and
        # the first decode step pay one-time costs (kernel build and
        # load, library handles) and are kept out of the estimates,
        # as the JAX engine keeps compiles out.
        self._prefill_ms_per_tok = 0.0
        self._decode_ewma_ms = 0.0
        self._hot_buckets: set = set()
        self._decode_hot = False
        self._queue: "queue.Queue[_GenRequest]" = queue.Queue(
            maxsize=int(max_queue))
        self._wake = threading.Event()
        self.batch_queue_fraction = float(batch_queue_fraction)
        self._batch_queue_limit = max(
            1, int(self.batch_queue_fraction * int(max_queue)))
        # work run on the scheduler thread between iterations (warmup)
        self._jobs: "collections.deque[Callable[[], None]]" = \
            collections.deque()
        # -- the fault ladder: seams fire only with an injector; the
        # supervised loop always runs (device faults need no injector)
        self._faults = fault_injector
        self._max_step_retries = int(max_step_retries)
        self._retry_backoff_s = float(retry_backoff_ms) / 1e3
        self._retry_backoff_max_s = float(retry_backoff_max_ms) / 1e3
        self._max_recoveries = int(max_recoveries_per_request)
        self._stall_timeout_s = float(stall_timeout_s)
        # requests re-admitted ahead of the queue: admissions a fault
        # interrupted and recovery's re-admissions (accepted earlier than
        # anything still queued)
        self._requeue: "collections.deque[_GenRequest]" = \
            collections.deque()
        self._beat = time.monotonic()  # scheduler heartbeat (alive())
        self._draining = False
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="generation-scheduler")
        self._thread.start()

    def _init_paged(self, block_size, num_blocks, prefill_chunk_tokens,
                    enable_prefix_sharing, prefix_index_capacity,
                    session_capacity):
        """Paged-backend configuration and host bookkeeping."""
        self.block_size = int(block_size)
        if not 1 <= self.block_size <= self.max_seq_len:
            raise ValueError(f"block_size {block_size} outside "
                             f"[1, max_seq_len]")
        # dense decode-table width: every position < max_seq_len has an
        # entry, so one table shape serves every decode step
        self._blocks_per_seq = blocks_for(self.max_seq_len,
                                          self.block_size)
        if num_blocks is None:
            # dense-equivalent capacity (+1 for the null block)
            num_blocks = self.num_slots * self._blocks_per_seq + 1
        self.num_blocks = int(num_blocks)
        # chunk ladder: the prompt buckets capped at the chunk size;
        # prefill_chunk_tokens=None means one chunk per prompt
        cap = self.prompt_buckets[-1]
        if prefill_chunk_tokens is not None:
            if int(prefill_chunk_tokens) < 1:
                raise ValueError("prefill_chunk_tokens must be >= 1")
            cap = min(pow2_bucket(int(prefill_chunk_tokens)), cap)
            self.prefill_chunk_tokens = cap
        self._chunk_cap = cap
        self.chunk_buckets = sorted(
            set(b for b in self.prompt_buckets if b < cap) | {cap})
        # largest per-request table bucket: the last chunk's bucket can
        # overshoot the allocation by < chunk_cap, and the overshoot
        # must stay inside the table. Indexing past a table raises (JAX
        # clamped to the last entry, a real block), so an undersized
        # table fails loudly instead of aliasing live data
        self._tbl_top = pow2_bucket(blocks_for(self.max_seq_len + cap,
                                               self.block_size))
        self._allocator = BlockAllocator(self.num_blocks)
        self._tables = np.full((self.num_slots, self._blocks_per_seq),
                               NULL_BLOCK, np.int32)
        self._slot_blocks: List[Optional[BlockTable]] = \
            [None] * self.num_slots
        self._prefilling: "collections.deque[_ChunkState]" = \
            collections.deque()
        self._held: Optional[_GenRequest] = None
        # prefix sharing: chained-hash index over full prompt blocks
        # and session pins, both scheduler-thread state
        self.enable_prefix_sharing = bool(enable_prefix_sharing)
        self._prefix_index = PrefixIndex(int(prefix_index_capacity))
        self._sessions = SessionStore(int(session_capacity))

    def _fresh_cache(self):
        """The slot cache sized to the engine's max_seq_len, or the
        block pool with ``model.cache_shapes(block_size)`` per block."""
        if self.cache_backend == "paged":
            return PagedKVCache(self.model.cache_shapes(self.block_size),
                                self.num_blocks, kv_dtype=self.kv_dtype,
                                device=self.device)
        return KVCache(self.model.cache_shapes(self.max_seq_len),
                       self.num_slots, kv_dtype=self.kv_dtype,
                       device=self.device)

    def _update_block_gauges(self):
        """Push allocator and liveness gauges into the metrics.
        ``kv_tokens_live`` counts each unique block once at its largest
        valid fill across owners, so a shared prefix is not counted
        twice."""
        a = self._allocator
        self.metrics.blocks_free = a.free_count
        self.metrics.blocks_peak_used = a.peak_used
        bs = self.block_size
        fill: Dict[int, int] = {}

        def cover(blocks, n_tokens):
            for i, b in enumerate(blocks):
                f = min(bs, int(n_tokens) - i * bs)
                if f <= 0:
                    break
                if f > fill.get(b, 0):
                    fill[b] = f

        st = self._slots
        for s in range(self.num_slots):
            if st.requests[s] is not None and st.step[s] > 0:
                t = self._slot_blocks[s]
                if t is not None:
                    cover(t.blocks, int(st.pos[s]) + 1)
        for c in self._prefilling:
            cover(c.table.blocks, c.done_tokens)
        for blocks, n in self._sessions.iter_pins():
            cover(blocks, n)
        for b in self._prefix_index.blocks():
            fill[b] = bs  # indexed blocks are full prompt blocks
        self.metrics.kv_tokens_live = sum(fill.values())
        self.metrics.kv_tokens_allocated = a.used_count * bs
        if self.kv_dtype == "int8":
            # every allocated block holds quantize-on-write content
            self.metrics.quant_blocks_quantized = a.used_count
        self.metrics.shared_blocks = a.shared_count
        self.metrics.prefix_blocks = len(self._prefix_index)
        self.metrics.sessions_live = len(self._sessions)

    # -- device calls ----------------------------------------------------
    def _prefill_call(self, tokens: np.ndarray, length: int, slot: int,
                      req: _GenRequest):
        """One prompt pass at its bucket: K/V slab written into the
        slot's cache row in place, first token sampled at the step-0
        fold. Returns (first token, logits all finite)."""
        dev = self.device
        model, params = self.model, self.model._params
        tok = torch.from_numpy(tokens).to(dev)
        bucket = tok.shape[1]
        key_mask = (torch.arange(bucket, device=dev)[None]
                    < length).to(torch.float32)
        logits, ks, vs = model.forward_prefill(params, tok, key_mask)
        # padded rows only see keys under key_mask, so a non-finite
        # value traces back to the request's own tokens
        ok = torch.isfinite(logits).all()
        # positions past ``length`` get the padded tail's K/V: masked
        # by the length, and overwritten as decode advances
        for kc, k in zip(self._kcs, ks):
            kv_update_slice(kc, k, (slot, 0, 0, 0))
        for vc, v in zip(self._vcs, vs):
            kv_update_slice(vc, v, (slot, 0, 0, 0))
        return self._sample_first(logits[0, length - 1], ok, req)

    def _chunk_call(self, tokens: np.ndarray, p0: int, clen: int,
                    table: np.ndarray, req: _GenRequest):
        """One prefill chunk on the paged pool: K/V written into the
        request's blocks in place, and the row ``clen - 1`` sampled at
        the step-0 fold (used only on the final chunk). Returns (that
        token, the valid rows' logits all finite)."""
        dev = self.device
        logits, _, _ = self.model.forward_prefill_chunk(
            self.model._params, torch.from_numpy(tokens).to(dev), p0, clen,
            self._kcs, self._vcs, torch.from_numpy(table).to(dev))
        # guard only rows < clen: padded rows attend positions past the
        # live length, stale junk that may be anything
        ok = torch.isfinite(logits[:clen]).all()
        return self._sample_first(logits[clen - 1], ok, req)

    def _sample_first(self, row, ok, req: _GenRequest):
        """Sample generation token #1 from the prompt's last logits row
        at the step-0 fold. Returns (token, ok) after one device sync."""
        dev = self.device
        u = (_uniforms(np.array([req.seed], np.uint32),
                       np.zeros(1, np.int32))
             if req.temperature > 0 else torch.zeros(1))
        first = _sample_from_logits(
            row[None],
            torch.tensor([req.temperature], dtype=torch.float32,
                         device=dev),
            torch.tensor([req.top_k], device=dev), u.to(dev))[0]
        out = torch.stack([first, ok.to(torch.int64)]).cpu()  # device sync
        return int(out[0]), bool(out[1])

    def _cow(self, src: int, dst: int):
        """Copy pool block ``src`` into ``dst`` (every layer, K and V)
        so the admitted request writes into its private copy while
        every other reader of ``src`` sees it bit-unchanged."""
        with self._profiler.record("generation.cow"):
            for pool in self._kcs + self._vcs:
                kv_copy_row(pool, src, dst)

    def _decode_step_fn(self, kcs, vcs, step_in, step_out):
        """One decode step over the full slot batch, from an input
        buffer laid out as ``_step_in`` to an output buffer laid out as
        ``_step_out`` (the engine's own buffers are what the CUDA graph
        captures; warmup passes scratch ones). Each lane's input token
        comes from the host mirror or, where ``use_host`` is 0, from the
        previous step's output, as the JAX engine's decode function
        takes it; done = the lane sampled its EOS or reached
        max_tokens."""
        S = self.num_slots
        n = len(_IN_ROWS) * S
        rows = step_in[:n].view(len(_IN_ROWS), S)
        tok_host, use_host, pos, top_ks, eos, steps, max_steps = \
            rows[:7].long()
        temps, us = rows[7:].view(torch.float32)
        tok = torch.where(use_host > 0, tok_host, step_out[0])
        if self.cache_backend == "paged":
            logits, _, _ = self.model.forward_decode_paged(
                self.model._params, tok, pos, kcs, vcs,
                step_in[n:].view(S, self._blocks_per_seq))
        else:
            logits, _, _ = self.model.forward_decode(
                self.model._params, tok, pos, kcs, vcs)
        ok = torch.isfinite(logits).all(dim=-1)  # per lane
        nxt = _sample_from_logits(logits, temps, top_ks, us)
        done = ((nxt == eos) & (eos >= 0)) | (steps + 1 >= max_steps)
        step_out.copy_(torch.stack([nxt, ok.long(), done.long()]))

    def _run_decode_step(self):
        self._decode_step_fn(self._kcs, self._vcs, self._step_in,
                             self._step_out)

    def _capture_decode_graph(self):
        """Capture :meth:`_decode_step_fn` into the engine's CUDA graph
        (counted in ``metrics.compiles``). The capture launches nothing:
        the kernels' launch counters are put back, and each replay adds
        what the capture counted. A failed capture raises."""
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._run_decode_step()
        except Exception as e:
            raise ServingError(
                f"capturing the decode step ({self.cache_backend}, "
                f"{self.kv_dtype}) into a CUDA graph failed: {e!r}") from e
        finally:
            counted = {k: n - before[k] for k, n in launch_counts().items()
                       if n != before[k]}
            add_launches({k: -n for k, n in counted.items()})
        self._graph_launches = counted
        self._graph = graph
        self.metrics.inc("compiles")

    def _host(self, shape, dtype) -> torch.Tensor:
        """A host buffer for one step's copies: pinned on the card (the
        caching host allocator reuses it only after its copies' events),
        plain memory on the CPU."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _dispatch_decode(self) -> bool:
        """Launch one decode step without waiting for it: the inputs go
        from a pinned buffer of the step's own into the static input
        buffer, the step runs (the graph's replay, or eagerly), and its
        [next token, ok, done] go into a pinned buffer of the step's own,
        all on the current stream; an event marks the step's end. Each
        stepped lane's current token then lives on the device (fed to
        the next step from the output buffer), and pos and step advance
        on the host at once. Returns False when no lane is ready."""
        st = self._slots
        active = self._ready_slots()
        if not active:
            return False
        # the seam fires before anything changes (the capture, the
        # buffers, the cursors): a TransientFault here is retried with
        # every state intact and the previous step still in flight
        self._hit("device_step")
        S = self.num_slots
        cold = not self._decode_hot
        if self._cuda_graph and self._graph is None and not cold:
            self._capture_decode_graph()
            cold = True
        h_in = self._host(self._step_in.shape, torch.int32)
        buf = h_in.numpy()
        n = len(_IN_ROWS) * S
        rows = buf[:n].reshape(len(_IN_ROWS), S)
        rows[:7] = (st.token, ~self._tok_on_dev, st.pos, st.top_k, st.eos,
                    st.step, st.max_steps)
        f32 = rows[7:].view(np.float32)
        f32[0] = st.temp
        # greedy lanes ignore their uniform: zeros when no lane samples
        f32[1] = (_uniforms(st.seed, st.step).numpy()
                  if (st.temp > 0).any() else 0.0)
        if self.cache_backend == "paged":
            buf[n:] = self._tables.reshape(-1)
        t0 = time.perf_counter()
        self._step_in.copy_(h_in, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            add_launches(self._graph_launches)
        else:
            self._run_decode_step()
        h_out = self._host((3, S), torch.int64)
        h_out.copy_(self._step_out, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._decode_hot = True
        self._tok_on_dev[:] = False
        self._tok_on_dev[active] = True
        st.pos[active] += 1
        st.step[active] += 1
        self.metrics.inc("decode_steps")
        self.metrics.occupancy_hist.record(len(active))
        # h_in rides along: its buffer lives until the step is collected
        self._pending.append((h_out, event, h_in, t0, cold,
                              [(s, st.requests[s]) for s in active]))
        return True

    def _collect_decode(self, keep: int = 0):
        """Sync and apply in-flight decode steps, oldest first, until
        only ``keep`` remain (keep=1 right after a dispatch: the new step
        stays in flight while this host work overlaps it). The event
        wait is the only blocking point. A lane whose slot retired or
        changed hands while its step was in flight is skipped: its write
        landed past its sequence's valid length and its token is never
        read."""
        st = self._slots
        while len(self._pending) > keep:
            h_out, event, _, t0, cold, lanes = self._pending.popleft()
            t_wait = time.perf_counter()
            if event is not None:
                event.synchronize()
            now = time.perf_counter()
            span_s, wait_s = now - t0, now - t_wait
            self._profiler.note("generation.decode_step", span_s)
            dt_ms = span_s * 1e3
            self.metrics.decode_step_ms.record(dt_ms)
            self.metrics.decode_sync_wait_ms.record(wait_s * 1e3)
            # a cold step (the first, or one that captured the graph)
            # pays one-time costs and stays out of the estimate
            if not cold:
                self._decode_ewma_ms = dt_ms if not self._decode_ewma_ms \
                    else 0.8 * self._decode_ewma_ms + 0.2 * dt_ms
            out = h_out.numpy()
            tokens = out[0].tolist()
            ok, done = out[1].astype(bool), out[2].astype(bool)
            emitted = 0
            itl: List[float] = []
            for slot, req in lanes:
                if st.requests[slot] is not req \
                        or req.finish_reason is not None \
                        or req.error is not None:
                    continue
                if not ok[slot]:
                    # poison quarantine: the guard is per lane, so only
                    # this request fails; its batchmates decode on
                    self.metrics.inc("quarantined")
                    exc = PoisonRequestError(
                        "request produced non-finite logits at decode "
                        f"step {int(st.step[slot])}; quarantined")
                    self._release_slot(slot)
                    self._fail(req, exc)
                    continue
                token = tokens[slot]
                # the host mirror; a step already dispatched took this
                # lane's token from the device
                st.token[slot] = token
                self._emit(req, token, now, itl_out=itl)
                emitted += 1
                self._retire(slot, req, token, bool(done[slot]), now)
            if emitted:
                self.metrics.tokens.record(emitted)
            if itl:
                self.metrics.itl_ms.record_many(itl)
            if self.cache_backend == "paged":
                self._update_block_gauges()

    def _drop_pending(self):
        """Discard the in-flight steps (recovery, poison, shutdown):
        nothing of a dropped step is ever emitted, so a recovery replay
        regenerates its tokens at the same PRNG folds, and every lane's
        next token comes from the host mirror (``use_host`` in the next
        step's input buffer)."""
        self._pending.clear()
        self._tok_on_dev[:] = False

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Run every prefill bucket (paged: every chunk bucket) and one
        decode step once, on the scheduler thread and on scratch
        tensors, so the first requests pay no one-time costs (kernel
        build and load, library handles); then, on the card, capture
        the decode step into the engine's CUDA graph. A failed capture
        raises. Returns the warmed bucket list."""
        paged = self.cache_backend == "paged"
        ladder = self.chunk_buckets if paged else self.prompt_buckets
        buckets = sorted(set(int(x) for x in (buckets or ladder)))
        for b in buckets:
            if b not in ladder:
                raise ValueError(
                    f"bucket {b} not in "
                    f"{'chunk_buckets' if paged else 'prompt_buckets'} "
                    f"{ladder}")

        def job():
            dev, model = self.device, self.model
            params = model._params
            if paged:
                bs = self.block_size
                # null block + one block: every scratch table entry is
                # NULL, and so is every scratch decode lane's
                scratch = PagedKVCache(model.cache_shapes(bs), 2,
                                       kv_dtype=self.kv_dtype, device=dev)
                for c in buckets:
                    tbl = torch.full((pow2_bucket(blocks_for(c, bs)),),
                                     NULL_BLOCK, dtype=torch.int32,
                                     device=dev)
                    model.forward_prefill_chunk(
                        params, torch.zeros((1, c), dtype=torch.int64,
                                            device=dev), 0, c, scratch.ks,
                        scratch.vs, tbl)
                    self._hot_buckets.add(c)
            else:
                for b in buckets:
                    model.forward_prefill(
                        params, torch.zeros((1, b), dtype=torch.int64,
                                            device=dev),
                        torch.ones((1, b), device=dev))
                    self._hot_buckets.add(b)
                # every lane decodes position 0 of a one-position slot
                scratch = KVCache(model.cache_shapes(1), self.num_slots,
                                  kv_dtype=self.kv_dtype, device=dev)
            self._decode_step_fn(scratch.ks, scratch.vs,
                                 torch.zeros_like(self._step_in),
                                 torch.zeros_like(self._step_out))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._decode_hot = True
            if self._cuda_graph and self._graph is None:
                self._capture_decode_graph()

        self._run_on_scheduler(job)
        self.metrics.warmed_buckets = sorted(
            set(self.metrics.warmed_buckets) | set(buckets))
        return buckets

    def _run_on_scheduler(self, fn: Callable[[], None]) -> None:
        done = threading.Event()
        err: List[BaseException] = []

        def job():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                done.set()

        if not self._running:
            raise ServingError("generation engine is stopped")
        self._jobs.append(job)
        self._wake.set()
        while not done.wait(0.1):
            if not self._thread.is_alive():
                raise ServingError("generation scheduler exited")
        if err:
            raise err[0]

    # -- client side -----------------------------------------------------
    def _make_request(self, prompt, max_tokens, temperature, top_k, seed,
                      eos_id, timeout_ms, stream, priority="interactive",
                      session_id=None) -> _GenRequest:
        if priority not in PRIORITIES:
            raise ClientError(f"unknown priority {priority!r}; expected "
                              f"one of {PRIORITIES}")
        if session_id is not None:
            if not isinstance(session_id, str) or not session_id:
                raise ClientError("session_id must be a non-empty "
                                  "string")
            if len(session_id) > 256:
                raise ClientError("session_id must be <= 256 chars")
            if self.cache_backend != "paged":
                raise ClientError("session_id requires the paged cache "
                                  "backend (cache='paged')")
            if not self.enable_prefix_sharing:
                raise ClientError(
                    "session_id requires prefix sharing "
                    "(enable_prefix_sharing=True)")
        if self._draining:
            self.metrics.inc("shed")
            raise DrainingError("generation engine is draining; retry "
                                "against another replica")
        if not self._running:
            raise ServingError("generation engine is stopped")
        try:
            raw = np.asarray(prompt)
        except (TypeError, ValueError) as e:
            raise ClientError(f"prompt is not a token array: {e}")
        if not np.issubdtype(raw.dtype, np.integer):
            # casting [3.7, 12.2] to [3, 12] would answer for the wrong
            # prompt without an error
            raise ClientError("prompt token ids must be integers")
        prompt = raw.astype(np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ClientError("prompt must be a non-empty 1-D list of "
                              "token ids")
        vocab = self.model.vocab_size
        if (prompt < 0).any() or (prompt >= vocab).any():
            raise ClientError(f"prompt token ids must be in [0, {vocab})")
        if len(prompt) > self.max_seq_len - 1:
            raise ClientError(
                f"prompt length {len(prompt)} leaves no room to generate "
                f"(max_seq_len {self.max_seq_len})")
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise ClientError("max_tokens must be >= 1")
        temperature = float(temperature)
        if not np.isfinite(temperature):
            raise ClientError("temperature must be finite")
        if timeout_ms is not None and not np.isfinite(float(timeout_ms)):
            raise ClientError("timeout_ms must be finite")
        top_k = int(top_k)
        # normalize the no-filter spellings here so every value reaching
        # the scheduler fits an int32 lane
        if top_k <= 0 or top_k >= vocab:
            top_k = 0
        elif top_k > TOP_K_CAP:
            raise ClientError(
                f"top_k {top_k} exceeds the engine's static top-k cap "
                f"({TOP_K_CAP}); use top_k=0 (or >= vocab) for "
                "unfiltered sampling")
        # the cache slot is the hard budget: prompt + generation fit it
        max_tokens = min(max_tokens, self.max_seq_len - len(prompt))
        if self.cache_backend == "paged":
            need = blocks_for(len(prompt) + max_tokens, self.block_size)
            if need > self._allocator.capacity:
                # no pool state could ever admit it: reject up front
                # rather than hold it at the queue head forever
                raise ClientError(
                    f"request needs {need} KV blocks but the pool has "
                    f"{self._allocator.capacity}; lower max_tokens or "
                    "grow num_blocks")
        if eos_id is None:
            eos_id = getattr(self.model, "eos_id", None)
        timeout = (self.default_timeout_ms if timeout_ms is None
                   else float(timeout_ms)) / 1000.0
        est_ms = self._est_cost_ms(len(prompt), max_tokens)
        if est_ms > timeout * 1e3:
            # measured rates say this request cannot finish inside its
            # own deadline: reject before any device work (504)
            self.metrics.inc("shed_deadline")
            self.metrics.inc("timeouts")
            raise DeadlineExceededError(
                f"estimated cost {est_ms:.0f} ms ({len(prompt)} prompt "
                f"tokens + {max_tokens} max_tokens at measured rates) "
                f"exceeds the {timeout * 1e3:.0f} ms deadline budget")
        return _GenRequest(prompt, max_tokens, temperature, top_k,
                           int(seed) & 0xFFFFFFFF, eos_id,
                           time.perf_counter() + timeout, stream,
                           priority=priority, session_id=session_id)

    def _bucket(self, prompt_len: int) -> int:
        return next(b for b in self.prompt_buckets if b >= prompt_len)

    def _padded_prefill_len(self, prompt_len: int) -> int:
        """Prompt positions the device computes over: the sum of the
        chunk plan's buckets (paged) or the prompt bucket (slots)."""
        if self.cache_backend == "paged":
            return sum(b for _, b, _ in self._chunk_plan(prompt_len))
        return self._bucket(prompt_len)

    def _est_cost_ms(self, prompt_len: int, max_tokens: int) -> float:
        """Worst-case service estimate from measured rates: prefill of
        the padded prompt plus ``max_tokens`` decode steps."""
        return (self._padded_prefill_len(prompt_len)
                * self._prefill_ms_per_tok
                + max_tokens * self._decode_ewma_ms)

    def _deadline_blown(self, req: _GenRequest,
                        now: Optional[float] = None) -> bool:
        """True when the time left cannot cover even a first token
        (prefill plus one decode step at measured rates)."""
        now = time.perf_counter() if now is None else now
        min_work_ms = (self._padded_prefill_len(len(req.prompt))
                       * self._prefill_ms_per_tok + self._decode_ewma_ms)
        return now > req.deadline - min_work_ms / 1e3

    def _enqueue(self, req: _GenRequest):
        if self._draining:
            self.metrics.inc("shed")
            raise DrainingError("generation engine is draining; retry "
                                "against another replica")
        if req.priority == "batch" and \
                self._queue.qsize() >= self._batch_queue_limit:
            self.metrics.inc("shed")
            self.metrics.inc("shed_batch")
            raise QueueFullError(
                f"generation queue at the batch-priority limit "
                f"({self._batch_queue_limit}/{self.metrics.queue_max});"
                f" shedding batch-class work first")
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.inc("shed")
            raise QueueFullError(
                f"generation queue full ({self.metrics.queue_max}); "
                "shedding load")
        self._wake.set()
        if not self._running:
            req.abandoned = True
            raise ServingError("generation engine is stopped")
        self.metrics.inc("requests")
        self.metrics.queue_depth = self._queue.qsize()

    def generate(self, prompt, max_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 priority: str = "interactive",
                 session_id: Optional[str] = None) -> Dict[str, Any]:
        """Blocking generate: returns ``{"tokens", "prompt_tokens",
        "finish_reason"}``. Raises :class:`ClientError`,
        :class:`QueueFullError`, :class:`DeadlineExceededError`,
        :class:`PoisonRequestError`, the error its own prefill call
        raised, or :class:`ServingError` when the fault ladder gave it
        up (see the module doc)."""
        req = self._submit(prompt, max_tokens, temperature, top_k, seed,
                           eos_id, timeout_ms, stream=False,
                           priority=priority, session_id=session_id)
        budget = req.deadline - time.perf_counter()
        if not req.event.wait(budget + 1.0):  # grace for the device call
            req.abandoned = True
            req.count_timeout_once(self.metrics)
            raise DeadlineExceededError(
                f"no result within {budget * 1e3:.0f} ms")
        if req.error is not None:
            raise req.error
        self.metrics.inc("responses")
        return req.result()

    def stream(self, prompt, max_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               priority: str = "interactive",
               session_id: Optional[str] = None) -> Iterator[Dict]:
        """Streaming generate: yields ``{"token", "index"}`` per token,
        then ``{"done": True, "finish_reason", ...}``. Admission errors
        raise here; later failures raise from the iterator."""
        req = self._submit(prompt, max_tokens, temperature, top_k, seed,
                           eos_id, timeout_ms, stream=True,
                           priority=priority, session_id=session_id)
        return _TokenStream(self, req)

    def _submit(self, *args, **kw) -> _GenRequest:
        """Validate and enqueue, counting pre-admission 5xx here."""
        try:
            req = self._make_request(*args, **kw)
            self._enqueue(req)
            return req
        except (ClientError, QueueFullError, DeadlineExceededError):
            raise  # counted via their own counters / the client's fault
        except Exception:
            self.metrics.inc("server_errors")
            raise

    # -- scheduler side --------------------------------------------------
    def _hit(self, seam: str):
        """Fire a fault-injection seam (one attribute load without an
        injector)."""
        fi = self._faults
        if fi is not None:
            fi.fire(seam)

    def _fail(self, req: _GenRequest, exc: BaseException,
              count: bool = True):
        """``count=False`` for shutdown drains: a restart is not an
        outage."""
        req.error = exc
        if isinstance(exc, DeadlineExceededError):
            req.count_timeout_once(self.metrics)
        elif count and not isinstance(exc, ClientError):
            self.metrics.inc("server_errors")
        if req.stream_q is not None:
            req.stream_q.put(("error", exc))
        req.event.set()

    def _emit(self, req: _GenRequest, token: int, now: float,
              itl_out: Optional[List[float]] = None):
        """Deliver one generated token (latency samples batched into
        ``itl_out`` when given)."""
        req.tokens.append(token)
        if req.t_first is None:
            req.t_first = now
            self.metrics.ttft_ms.record((now - req.t_submit) * 1e3)
        elif itl_out is not None:
            itl_out.append((now - req.t_last) * 1e3)
        else:
            self.metrics.itl_ms.record((now - req.t_last) * 1e3)
        req.t_last = now
        if req.stream_q is not None:
            req.stream_q.put(("token", token))
            fi = self._faults
            if fi is not None and fi.fire("client_disconnect"):
                # as if the consumer hung up mid-stream: the scheduler
                # frees the slot at the next retirement check
                req.abandoned = True

    def _release_slot(self, slot: int):
        """Free a slot and (paged) its blocks and decode-table row. No
        zeroing either way (see serving/kvcache.py, serving/paging.py)."""
        self._slots.free(slot)
        self._tok_on_dev[slot] = False
        if self.cache_backend == "paged":
            table = self._slot_blocks[slot]
            if table is not None:
                self._allocator.free(table.blocks)
                self._slot_blocks[slot] = None
            self._tables[slot] = NULL_BLOCK
            self._update_block_gauges()
        self.metrics.active_slots = self._slots.active_count

    def _finish(self, slot: int, req: _GenRequest, reason: str):
        req.finish_reason = reason
        if req.session_id is not None and self.enable_prefix_sharing:
            # a clean finish with a session pins its blocks for the next
            # turn; failure paths release through _release_slot
            self._pin_session(slot, req)
        else:
            self._release_slot(slot)
        if req.stream_q is not None:
            req.stream_q.put(("done", reason))
        req.event.set()

    def _check_done(self, slot: int, req: _GenRequest, token: int) -> bool:
        """Host-side retirement test after prefill's first token; EOS
        wins over length so the reason is stable when both trip."""
        if req.abandoned:
            self._release_slot(slot)
            return True
        if req.eos_id is not None and token == req.eos_id:
            self._finish(slot, req, "eos")
            return True
        if len(req.tokens) >= req.max_tokens:
            self._finish(slot, req, "length")
            return True
        if time.perf_counter() > req.deadline:
            self._release_slot(slot)
            self._fail(req, DeadlineExceededError(
                "deadline exceeded mid-generation "
                f"({len(req.tokens)} tokens emitted)"))
            return True
        return False

    def _retire(self, slot: int, req: _GenRequest, token: int,
                done: bool, now: float) -> bool:
        """Retirement off the decode step's ``done`` flag (EOS |
        length); the host only tells which one tripped. Abandonment and
        deadline are host conditions."""
        if req.abandoned:
            self._release_slot(slot)
            return True
        if done:
            if req.eos_id is not None and token == req.eos_id:
                self._finish(slot, req, "eos")
            else:
                self._finish(slot, req, "length")
            return True
        if now > req.deadline:
            self._release_slot(slot)
            self._fail(req, DeadlineExceededError(
                "deadline exceeded mid-generation "
                f"({len(req.tokens)} tokens emitted)"))
            return True
        return False

    def _next_queued(self, busy: bool) -> Optional[_GenRequest]:
        """Pop the next queued request. A busy engine must keep
        decoding, so the pop does not block; an idle one parks on the
        submit-wake event (clear-then-recheck closes the lost-wakeup
        race), with a backstop in case a wake is lost that stays well
        under the stall watchdog, so an idle engine never looks wedged
        to :meth:`alive`."""
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            if busy:
                return None
        self._wake.clear()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            if not self._jobs:
                self._wake.wait(
                    max(0.05, min(1.0, self._stall_timeout_s / 4.0)))
            return None

    def _admit(self):
        """Fill free slots, the re-admission deque first (its requests
        were accepted before anything still queued).

        Fault contract of one admission: a :class:`TransientFault`
        (injected before any state changed) re-stashes the request and
        propagates, so the loop retries with backoff; a
        :class:`CorruptedStateFault` propagates for recompute-recovery,
        re-stashing the request unless it was failed already (a prefill
        call that raised fails its own request); anything else fails
        just this request."""
        if self.cache_backend == "paged":
            return self._admit_paged()
        while self._running and self._slots.free_count and not self._jobs:
            if self._requeue:
                req = self._requeue.popleft()
            else:
                req = self._next_queued(busy=bool(self._slots.active_count
                                                  or self._pending))
                if req is None:
                    return
                self.metrics.queue_depth = self._queue.qsize()
            if req.abandoned:
                continue
            if self._deadline_blown(req):
                # the deadline budget went while queued: shed at
                # dequeue, no device work spent on it
                self.metrics.inc("shed_deadline")
                self._fail(req, DeadlineExceededError(
                    "deadline budget exhausted in the generation queue"))
                continue
            try:
                self._prefill(req)
            except TransientFault:
                self._requeue.appendleft(req)
                raise
            except CorruptedStateFault:
                if req.error is None and req.finish_reason is None:
                    self._requeue.appendleft(req)
                raise
            except Exception as e:  # noqa: BLE001 — fails one request
                self._fail(req, e)

    def _prefill(self, req: _GenRequest):
        """Prefill a request into a fresh slot: its prompt, or after a
        recovery :func:`_recovery_seq`. A prefill call that raises fails
        this request with its error and raises
        :class:`CorruptedStateFault`: the call may have written any
        slot's cache, so the others recover."""
        # before the slot claim: a TransientFault leaves nothing to undo
        self._hit("prefill")
        seq = _recovery_seq(req)
        slot = self._slots.alloc(req)
        if slot is None:  # _admit checks free_count first
            raise ServingError("no free slot for admission")
        L = len(seq)
        # the smallest configured bucket, not the raw pow2 ladder; a
        # recovery prefix fits too (max_seq_len is always a bucket)
        bucket = self._bucket(L)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :L] = seq
        t0 = time.perf_counter()
        try:
            with self._profiler.record("generation.prefill"):
                first, ok = self._prefill_call(tokens, L, slot, req)
        except Exception as e:
            self._release_slot(slot)
            self._fail(req, e)
            raise CorruptedStateFault(
                f"prefill device call failed: {e!r}") from e
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._note_prefill_cost(dt_ms, bucket)
        self.metrics.inc("prefills")
        self.metrics.prompt_bucket_hist.record(bucket)
        if not ok:
            # poison quarantine: only this request's logits are
            # non-finite. Its NaN K/V rows stay in the cache as stale
            # tail data, which the length mask keeps unread.
            self._release_slot(slot)
            self.metrics.inc("quarantined")
            self._fail(req, PoisonRequestError(
                "request produced non-finite logits during prefill; "
                "quarantined"))
            return
        self._start_decode(slot, req, first, L)

    def _start_decode(self, slot: int, req: _GenRequest, first: int,
                      L: int):
        """Make a prefilled request (``L`` positions of K/V written) a
        decode lane. A fresh request's first token is prefill's, and is
        delivered. A recovered request's stream stands: it resumes from
        its last emitted token at the PRNG fold a fault-free run would
        use next, and prefill's token is discarded."""
        st = self._slots
        resumed = bool(req.tokens)
        st.token[slot] = req.tokens[-1] if resumed else first
        st.pos[slot] = L  # where the next token's K/V goes
        # the PRNG fold of the next sample
        st.step[slot] = len(req.tokens) if resumed else 1
        st.seed[slot] = req.seed
        st.temp[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.eos[slot] = -1 if req.eos_id is None else req.eos_id
        st.max_steps[slot] = req.max_tokens
        # the lane's token was written here: the next step takes it from
        # the host mirror, not the device
        self._tok_on_dev[slot] = False
        self.metrics.active_slots = st.active_count
        if self.cache_backend == "paged":
            self._update_block_gauges()
        if resumed:
            return
        self.metrics.tokens.record(1)
        self._emit(req, first, time.perf_counter())
        self._check_done(slot, req, first)

    def _note_prefill_cost(self, dt_ms: float, bucket: int):
        """Record one prefill (or chunk) call and feed the per-token
        EWMA, except from a bucket's first call, which pays one-time
        costs."""
        self.metrics.prefill_ms.record(dt_ms)
        if bucket in self._hot_buckets:
            self._prefill_ms_per_tok = dt_ms / bucket \
                if not self._prefill_ms_per_tok else \
                0.8 * self._prefill_ms_per_tok + 0.2 * dt_ms / bucket
        self._hot_buckets.add(bucket)

    # -- paged backend ---------------------------------------------------
    def _chunk_plan(self, prompt_len: int,
                    start: int = 0) -> List[Tuple[int, int, int]]:
        """Split a prompt into (start, chunk bucket, valid length)
        pieces: full ``_chunk_cap`` chunks, then the remainder in the
        smallest chunk bucket that holds it. ``start`` > 0 (a prefix
        match) skips the matched tokens."""
        plan = []
        p0 = int(start)
        while p0 < prompt_len:
            rem = prompt_len - p0
            if rem >= self._chunk_cap:
                bucket = clen = self._chunk_cap
            else:
                bucket = next(c for c in self.chunk_buckets if c >= rem)
                clen = rem
            plan.append((p0, bucket, clen))
            p0 += clen
        return plan

    def _match_prefix(self, req: _GenRequest
                      ) -> Tuple[int, List[int], Optional[int]]:
        """Longest cached prefix of the prompt -> ``(match_len,
        shared_blocks, cow_src)``. The session store is consulted first
        (token-granular), then the prefix index (block-granular).
        ``shared_blocks`` are matched full blocks the request reads
        through its table; ``cow_src`` holds the matched tail when the
        match ends mid-block, and admission copies it into a private
        block because the request writes there from ``match_len`` on.
        ``match_len`` is capped at len(prompt) - 1: the last prompt
        position is computed to sample the first token. A recovery's
        re-admission (tokens already emitted) never matches: its block
        budget and its token stream are settled."""
        if not self.enable_prefix_sharing or req.tokens:
            return 0, [], None
        bs = self.block_size
        prompt = req.prompt
        L = len(prompt)
        if req.session_id is not None:
            sess = self._sessions.get(req.session_id)
            if sess is not None:
                stored = sess.tokens
                n = min(len(stored), L - 1)
                neq = stored[:n] != prompt[:n]
                m = int(np.argmax(neq)) if neq.any() else n
                if m > 0:
                    self.metrics.inc("session_hits")
                    self.metrics.inc("prefix_hits")
                    self.metrics.inc("prefix_tokens_matched", m)
                    cow = sess.blocks[m // bs] if m % bs else None
                    return m, list(sess.blocks[:m // bs]), cow
            self.metrics.inc("session_misses")
        matched = self._prefix_index.match(chain_hashes(prompt, bs))
        if not matched:
            return 0, [], None
        m = len(matched) * bs
        cow = None
        if m >= L:
            # a block-aligned prompt matched whole: keep its last block
            # as a COW source so only the final position re-prefills
            m = L - 1
            matched, cow = matched[:m // bs], matched[m // bs]
        self.metrics.inc("prefix_hits")
        self.metrics.inc("prefix_tokens_matched", m)
        return m, list(matched), cow

    def _evict_one_pin(self) -> bool:
        """Release ONE cache pin under block pressure: the LRU prefix
        index entry first, then the LRU session. False when nothing is
        evictable."""
        b = self._prefix_index.evict_lru()
        if b is not None:
            self._allocator.free([b])
            self.metrics.inc("prefix_evictions")
            return True
        sess = self._sessions.evict_lru()
        if sess is not None:
            self._allocator.free(sess.blocks)
            self.metrics.inc("session_evictions")
            return True
        return False

    def _alloc_with_eviction(self, n: int) -> Optional[List[int]]:
        """All-or-nothing alloc that reclaims cache pins under pressure
        (in-flight requests outrank caching). None only when even an
        evicted pool cannot cover ``n``."""
        while True:
            blocks = self._allocator.alloc(n)
            if blocks is not None:
                return blocks
            if not self._evict_one_pin():
                return None

    def _admit_paged(self):
        """Paged admission: claim a slot AND the request's worst-case
        block count, all or nothing. When blocks run out the request is
        HELD at the queue head (FIFO) until retirements free blocks.
        Admission only starts the prefill; chunks run one per loop
        iteration. The re-admission deque is served first, then the
        held request, then the queue. Faults follow :meth:`_admit`'s
        contract: the ``alloc`` seam fires before anything is claimed,
        and a failed copy-on-write re-stashes the request and raises
        :class:`CorruptedStateFault`."""
        while self._running and self._slots.free_count and not self._jobs:
            if self._requeue:
                req = self._requeue.popleft()
            elif self._held is not None:
                req, self._held = self._held, None
            else:
                req = self._next_queued(
                    busy=bool(self._slots.active_count
                              or self._prefilling or self._pending))
                if req is None:
                    return
                self.metrics.queue_depth = self._queue.qsize()
            if req.abandoned:
                continue
            if self._deadline_blown(req):
                self.metrics.inc("shed_deadline")
                self._fail(req, DeadlineExceededError(
                    "deadline budget exhausted in the generation queue"))
                continue
            seq = _recovery_seq(req)
            L = len(seq)
            # a recovery does not change the block budget: prefix +
            # remaining generation = prompt + max_tokens positions
            need = blocks_for(len(req.prompt) + req.max_tokens,
                              self.block_size)
            try:
                self._hit("alloc")
            except (TransientFault, CorruptedStateFault):
                # nothing claimed yet: the retry (or recovery) re-admits
                # the request, in order
                self._requeue.appendleft(req)
                raise
            match_len, shared, cow_src = self._match_prefix(req)
            pinned = shared + ([cow_src] if cow_src is not None else [])
            if pinned:
                # pin the matched blocks BEFORE allocating: the alloc
                # may evict the index or session entries that own them,
                # and an evicted match must not come back as someone's
                # fresh block while this request still reads it
                self._allocator.share(pinned)
            fresh = self._alloc_with_eviction(need - len(shared))
            if fresh is None:
                if pinned:
                    self._allocator.free(pinned)
                if self._held is None:
                    self._held = req
                else:
                    # another request already waits for blocks (this one
                    # came from the re-admission deque): it goes back
                    # there, ahead of the held one's successors
                    self._requeue.appendleft(req)
                return
            if cow_src is not None:
                # the match ends mid-block: the request writes positions
                # >= match_len there, so it gets a private copy (its
                # first fresh block) and drops its pin on the original
                try:
                    self._cow(cow_src, fresh[0])
                except Exception as e:  # noqa: BLE001 — the pool may be
                    # half written: recovery rebuilds it
                    self._requeue.appendleft(req)
                    raise CorruptedStateFault(
                        f"copy-on-write device call failed: {e!r}") from e
                self._allocator.free([cow_src])
                self.metrics.inc("cow_copies")
            table = BlockTable(shared + fresh, self.block_size)
            plan = self._chunk_plan(L, start=match_len)
            # the table bucket also covers the last chunk's padded tail:
            # rows inside the allocation land past the live length,
            # rows past it on NULL entries, never on another request's
            # blocks
            span = max(len(req.prompt) + req.max_tokens,
                       plan[-1][0] + plan[-1][1])
            tbl_bucket = pow2_bucket(blocks_for(span, self.block_size),
                                     cap=self._tbl_top)
            slot = self._slots.alloc(req)
            self._slot_blocks[slot] = table
            self._prefilling.append(_ChunkState(
                req, slot, table, tbl_bucket, plan, seq, start=match_len))
            self.metrics.active_slots = self._slots.active_count
            self._update_block_gauges()

    def _prefill_chunk_step(self):
        """Run ONE prefill chunk of the oldest mid-prefill request. A
        chunk call that raises fails that request with its error,
        returns its blocks and raises :class:`CorruptedStateFault` for
        the others' recovery."""
        st = self._prefilling[0]
        req = st.req
        if req.abandoned:
            self._prefilling.popleft()
            self._release_slot(st.slot)
            return
        if time.perf_counter() > req.deadline:
            self._prefilling.popleft()
            self._release_slot(st.slot)
            self._fail(req, DeadlineExceededError(
                "deadline exceeded during chunked prefill "
                f"({st.done_tokens}/{len(st.seq)} prompt tokens)"))
            return
        # before any change: after a TransientFault the chunk state is
        # still at the deque head, and the retried iteration re-runs it
        self._hit("prefill")
        p0, bucket, clen = st.plan[st.idx]
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :clen] = st.seq[p0:p0 + clen]
        t0 = time.perf_counter()
        try:
            with self._profiler.record("generation.prefill"):
                first, ok = self._chunk_call(
                    tokens, p0, clen, st.table.padded(st.tbl_bucket), req)
        except Exception as e:
            self._prefilling.popleft()
            self._release_slot(st.slot)
            self._fail(req, e)
            raise CorruptedStateFault(
                f"prefill chunk device call failed: {e!r}") from e
        self._note_prefill_cost((time.perf_counter() - t0) * 1e3, bucket)
        self.metrics.inc("prefill_chunks")
        self.metrics.inc("prefill_tokens", clen)
        self.metrics.prompt_bucket_hist.record(bucket)
        if not ok:
            # poison quarantine: this request's own tokens drove its
            # logits non-finite; fail it alone and free its blocks
            self._prefilling.popleft()
            self._release_slot(st.slot)
            self.metrics.inc("quarantined")
            self._fail(req, PoisonRequestError(
                "request produced non-finite logits during prefill; "
                "quarantined"))
            return
        st.idx += 1
        if st.idx < len(st.plan):
            return
        # final chunk: the request becomes a decode lane
        self._prefilling.popleft()
        self.metrics.inc("prefills")
        if len(st.plan) > 1:
            self.metrics.inc("chunked_prefills")
        self._tables[st.slot] = st.table.padded(self._blocks_per_seq)
        if self.enable_prefix_sharing and not req.tokens:
            # the prompt's full blocks now hold finished, immutable K/V
            # (decode writes land at pos >= prompt length): publish them
            self._register_prefix(req, st.table)
        self._start_decode(st.slot, req, first, len(st.seq))

    def _register_prefix(self, req: _GenRequest, table: BlockTable):
        """Publish a prefilled prompt's FULL blocks into the prefix
        index. A newly registered block gains one reference owned by
        the index; a digest already present keeps its block."""
        n_full = len(req.prompt) // self.block_size
        if not n_full:
            return
        hashes = chain_hashes(req.prompt, self.block_size)
        for h, b in zip(hashes, table.blocks[:n_full]):
            if self._prefix_index.register(h, b):
                self._allocator.share([b])
        evicted = self._prefix_index.evict_over_capacity()
        if evicted:
            self._allocator.free(evicted)
            self.metrics.inc("prefix_evictions", len(evicted))

    def _pin_session(self, slot: int, req: _GenRequest):
        """Hand a cleanly finished request's K/V-valid blocks to the
        session store instead of freeing them: the store inherits the
        request's reference. Blocks past the K/V-valid prefix (prompt +
        emitted tokens minus the last, whose K/V was never written) are
        freed now. Mirrors :meth:`_release_slot`'s slot bookkeeping."""
        table = self._slot_blocks[slot]
        seq = _recovery_seq(req)
        keep = blocks_for(len(seq), self.block_size)
        kept, trailing = table.blocks[:keep], table.blocks[keep:]
        if trailing:
            self._allocator.free(trailing)
        evictions = 0
        for sess in self._sessions.put(req.session_id, seq, kept):
            self._allocator.free(sess.blocks)
            # the same session's superseded pin is not an eviction
            evictions += sess.session_id != req.session_id
        if evictions:
            self.metrics.inc("session_evictions", evictions)
        self._slots.free(slot)
        self._slot_blocks[slot] = None
        self._tables[slot] = NULL_BLOCK
        self._update_block_gauges()
        self.metrics.active_slots = self._slots.active_count

    def _ready_slots(self) -> List[int]:
        """Slots in the decode phase (step > 0). A paged slot is claimed
        at admission but decodes only after its final chunk; until then
        it rides the batch with a NULL table and its output is never
        read."""
        st = self._slots
        return [s for s in range(self.num_slots)
                if st.requests[s] is not None and st.step[s] > 0]

    def _reset_blocks(self):
        """Paged backend, after the cache was reset and every request
        taken off its slot: reset the block bookkeeping wholesale, the
        prefix index and the session pins included (their K/V went with
        the cache). Mid-prefill requests hold slots too, so the slot
        sweep collected them already."""
        if self.cache_backend != "paged":
            return
        self._prefilling.clear()
        self._allocator = BlockAllocator(self.num_blocks)
        self._tables[:] = NULL_BLOCK
        self._slot_blocks = [None] * self.num_slots
        self._prefix_index.clear()
        self._sessions.clear()
        self._update_block_gauges()

    def _poison(self, why: str):
        """Last resort (recovery itself raised): every in-flight
        sequence lost its K/V and cannot be rebuilt. Fail them all
        loudly, then reset the cache so the engine stays servable. A
        reset that raises again (a sticky CUDA error) ends the scheduler
        thread; :meth:`alive` then reports False."""
        st = self._slots
        for slot in st.active_slots():
            req = st.requests[slot]
            st.free(slot)
            self._fail(req, ServingError(f"generation step failed: "
                                         f"{why}"))
        self.metrics.active_slots = 0
        self._drop_pending()
        self._reset_blocks()
        # in place: the decode step's CUDA graph keeps its addresses
        self._cache.reset()

    def _recover(self, why: str):
        """Recompute-recovery: decode state is a pure function of the
        prompt and the emitted tokens, so after a cache-corrupting
        failure every in-flight request is re-admitted at the FRONT of
        the line and re-prefilled from :func:`_recovery_seq`; its PRNG
        stream continues at ``fold_in(seed, len(tokens))``, so its
        output is the fault-free run's and no accepted request is lost.
        The in-flight decode steps die with the cache: nothing of them
        was emitted, so the replay regenerates them at the same folds.
        Only requests that ride ``max_recoveries_per_request``
        recoveries, or outlive their deadline, fail. The cache is zeroed
        IN PLACE (the decode step's CUDA graph replays on the same
        storage, never recaptured), and before any request leaves its
        slot, so a reset that raises leaves :meth:`_poison` every
        request to fail."""
        self._drop_pending()
        self._cache.reset()
        st = self._slots
        recovered: List[_GenRequest] = []
        for slot in st.active_slots():
            recovered.append(st.requests[slot])
            st.free(slot)
        self.metrics.active_slots = 0
        self._reset_blocks()
        now = time.perf_counter()
        for req in recovered:
            if req.abandoned:
                continue
            if now > req.deadline:
                self._fail(req, DeadlineExceededError(
                    "deadline exceeded during fault recovery "
                    f"({len(req.tokens)} tokens emitted)"))
            elif req.recoveries >= self._max_recoveries:
                # a request that rides every crash is probably causing
                # them: attribution of last resort
                self._fail(req, ServingError(
                    f"request failed {req.recoveries} recovery "
                    f"attempts: {why}"))
            else:
                req.recoveries += 1
                self._requeue.append(req)

    def _fail_all(self, exc: BaseException):
        """Shutdown: fail what is queued for re-admission, the request
        held for blocks and every slot's request (decoding or
        mid-prefill) with ``exc``, uncounted (a restart is not an
        outage), releasing their slots and blocks."""
        for req in self._requeue:
            self._fail(req, exc, count=False)
        self._requeue.clear()
        if self.cache_backend == "paged":
            self._prefilling.clear()  # their slots are released below
            if self._held is not None:
                self._fail(self._held, exc, count=False)
                self._held = None
        for slot in self._slots.active_slots():
            req = self._slots.requests[slot]
            self._release_slot(slot)
            if req.error is None:
                self._fail(req, exc, count=False)
        self.metrics.active_slots = 0

    def _loop(self):
        """The supervised scheduler: run queued jobs (warmup, admin),
        admit, run one prefill chunk (paged), dispatch one decode step
        and collect the previous one (pipelined) or this one
        (synchronous). The fault ladder (see the module doc): a
        :class:`TransientFault` retries with backoff up to
        ``max_step_retries`` strikes, then recovers; anything else
        recovers at once; a recovery that raises poisons. A job's
        exception goes back to its caller, never to the ladder. The
        heartbeat goes stale only when an iteration hangs."""
        paged = self.cache_backend == "paged"
        backoff = self._retry_backoff_s
        strikes = 0
        with torch.inference_mode():
            while self._running:
                self._beat = time.monotonic()
                try:
                    while self._jobs:
                        self._jobs.popleft()()
                    self._hit("latency")  # injected tail latency (sleeps)
                    self._admit()
                    if paged and self._prefilling:
                        self._prefill_chunk_step()
                    # dispatch step t+1 first, then collect step t: the
                    # admit and prefill work above and the emit/retire
                    # work in the collect overlap the step just launched
                    launched = self._dispatch_decode()
                    self._collect_decode(
                        keep=1 if launched and self.decode_pipeline else 0)
                except TransientFault as e:
                    strikes += 1
                    if strikes > self._max_step_retries:
                        # bounded give-up: rebuild rather than spin
                        self.metrics.inc("recoveries")
                        try:
                            self._recover(f"retries exhausted: {e!r}")
                        except Exception as e2:  # noqa: BLE001
                            self._poison(repr(e2))
                        strikes = 0
                        backoff = self._retry_backoff_s
                    else:
                        self.metrics.inc("retries")
                        time.sleep(backoff)
                        backoff = min(backoff * 2.0,
                                      self._retry_backoff_max_s)
                except Exception as e:  # noqa: BLE001 — cache-corrupting
                    # or a device error: rebuild the in-flight state
                    self.metrics.inc("recoveries")
                    try:
                        self._recover(repr(e))
                    except Exception as e2:  # noqa: BLE001
                        self._poison(repr(e2))
                    strikes = 0
                    backoff = self._retry_backoff_s
                else:
                    strikes = 0
                    backoff = self._retry_backoff_s
        # shutdown runs on this thread, so no slot-table mutation races
        # a device call still in flight
        self._drop_pending()
        while self._jobs:
            self._jobs.popleft()()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail(req, ServingError("generation engine stopped"),
                       count=False)
        self._fail_all(ServingError("generation engine stopped"))

    # -- admin -----------------------------------------------------------
    def stats(self) -> Dict:
        return self.metrics.snapshot()

    def _on_scheduler(self, fn: Callable[[], int]) -> int:
        """Run an admin change of scheduler-thread state on that thread
        while it runs (so it never races a step), directly once it has
        stopped."""
        if not (self._running and self._thread.is_alive()):
            return fn()
        out: List[int] = []
        self._run_on_scheduler(lambda: out.append(fn()))
        return out[0]

    def evict_sessions(self) -> int:
        """Release every session pin; returns how many sessions were
        evicted (0 on the slot backend)."""
        if self.cache_backend != "paged":
            return 0

        def job() -> int:
            sessions = self._sessions.clear()
            for sess in sessions:
                self._allocator.free(sess.blocks)
            if sessions:
                self.metrics.inc("session_evictions", len(sessions))
            self._update_block_gauges()
            return len(sessions)
        return self._on_scheduler(job)

    def clear_prefix_cache(self) -> int:
        """Release every prefix-index pin; returns how many blocks were
        unpinned (0 on the slot backend)."""
        if self.cache_backend != "paged":
            return 0

        def job() -> int:
            blocks = self._prefix_index.clear()
            if blocks:
                self._allocator.free(blocks)
                self.metrics.inc("prefix_evictions", len(blocks))
            self._update_block_gauges()
            return len(blocks)
        return self._on_scheduler(job)

    def set_fault_injector(self, injector) -> None:
        """Swap the fault injector (``None`` disables injection). The
        seams read it on every call, so one warmed engine serves fault
        scenario after fault scenario, with no new capture."""
        self._faults = injector

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` has started (new submissions are
        shed with :class:`DrainingError`)."""
        return self._draining

    def alive(self) -> bool:
        """Liveness: False only when the scheduler is wedged, its thread
        dead while it should run or no heartbeat within
        ``stall_timeout_s`` (the loop beats every iteration; its longest
        legitimate pause is one device call). A stopped or drained
        engine is not wedged."""
        if not self._running:
            return True
        if not self._thread.is_alive():
            return False
        return (time.monotonic() - self._beat) <= self._stall_timeout_s

    def _idle(self) -> bool:
        empty = (self._queue.empty() and not self._requeue
                 and self._slots.active_count == 0)
        if self.cache_backend == "paged":
            empty = empty and not self._prefilling and self._held is None
        return empty

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: new submissions get 503
        (:class:`DrainingError`), queued and in-flight generations run
        to completion, then the scheduler stops. True when fully
        drained within ``timeout_s``."""
        first = not self._draining
        self._draining = True
        if first:
            self.metrics.inc("drains")
        self._wake.set()
        clean = poll_until_idle(self._idle, timeout_s)
        self.stop()
        return clean

    def stop(self, timeout_s: float = 5.0):
        """Stop the scheduler; its exit path fails what is queued or in
        flight."""
        self._running = False
        self._wake.set()
        self._thread.join(timeout=timeout_s)
