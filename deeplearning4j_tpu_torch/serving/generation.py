"""Continuous-batching autoregressive generation (counterpart of
``deeplearning4j_tpu/serving/generation.py``: the slot and paged
backends, the pipelined decode loop and speculative decoding).

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

With ``speculation_k`` > 0 (``serving/speculative.py``) step 2 is
preceded by a speculative round: one draft call proposes k tokens for
every lane, each eligible lane's proposals are verified in one target
span, and the lanes it advanced ride the plain step as passengers.
Tokens are those of ``speculation_k=0``.

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
every step. So is every other executable of the JAX engine, one graph
per shape bucket: the slot prefill per prompt bucket (first token
sampled inside), the paged chunk per (chunk bucket, table bucket), the
copy-on-write copy, the draft's proposal, the draft prime per prime
bucket and the verify span (per table bucket on the paged backend).
Each reads its per-call values from one static device buffer of its
kind and writes its results to another, which one pinned copy and one
event bring to the host: a call is a host-to-device copy, a replay and
one sync. :meth:`graph_plan` is the set :meth:`warmup` captures (the
JAX engine's warm set); ``metrics.compiles`` counts captures, so after
warmup it equals the JAX engine's compiles.

With ``offload_host_bytes`` > 0 (paged backend, prefix sharing on) the
hierarchical KV tier (``serving/offload.py``) sits below the block
pool: an evicted session pin or prefix-index entry is DEMOTED (its
block run gathered into host RAM, spilling to an optional mmap'd disk
ring) instead of discarded, and a returning session, or a prompt whose
chained hashes match a demoted prefix, RESTORES its run into freshly
allocated blocks before matching, so the turn pays only its suffix
prefill. The gather and the scatter are CUDA graphs too, one pair per
power-of-two run bucket (in :meth:`graph_plan`), over a static index
buffer and one static row buffer of the largest bucket, through one
fixed pinned staging buffer; the scatter writes the pool in place. A
prefetch thread reads demoted runs (disk included) and builds their
padded host operands while the resume waits in the queue.

A request traced by the caller (``trace=``, a
:class:`~..tracing.Trace`) records the JAX engine's spans with the same
attributes: ``admission`` (admitted, shed at submit, expired at
dequeue) and the ``queue`` wait at submit, ``offload_restore``,
``prefix_match`` and one ``prefill`` per prefill call or chunk at
admission, ``recovery`` per re-admission, and at its end ``decode`` (or
``error``), ``step_pipeline``, ``draft`` and ``verify``, rebuilt from
what the engine keeps per request. Every site is one ``if req.trace is
not None`` on the host; the decode loop carries none, and tracing adds
no device call, sync or capture. :func:`~.metrics.prometheus_text`
renders :meth:`GenerationEngine.stats` as Prometheus text.

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
import os
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
from ..kernels import add_launches
from ..kernels.kv_quant import (QuantArray, canonical_kv_dtype,
                                is_quantized, kv_copy_row, kv_pack_host,
                                kv_tensors, kv_unpack_host, kv_update_slice,
                                kv_zeros)
from ..profiler import OpProfiler
from .batcher import (PRIORITIES, DeadlineExceededError, DrainingError,
                      QueueFullError)
from .engine import ClientError, ServingError, capture_graph
from .kvcache import KVCache, SlotTable
from .metrics import GenerationMetrics
from .offload import DiskRing, HostBlockStore, HostRun, OffloadPrefetcher
from .paging import (NULL_BLOCK, BlockAllocator, BlockTable, PagedKVCache,
                     PrefixIndex, SessionStore, blocks_for, chain_hashes,
                     export_block_run, import_block_run, pow2_bucket)
from .speculative import (make_prime_fn, make_propose_fn,
                          make_verify_paged_fn, make_verify_slots_fn,
                          verify_bucket, verify_uniforms)

_NEG_INF = -1e30

#: static cap on per-request top_k (the filter thresholds against
#: ``topk(logits, cap)``); top_k >= vocab means no filter
TOP_K_CAP = 128

#: the int32 rows of the decode step's input buffer, one entry per lane
#: each (temp and uniform hold f32 bits); the paged tables follow
_IN_ROWS = ("tok_host", "use_host", "pos", "top_k", "eos", "step",
            "max_steps", "temp", "uniform")


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


def _pinned_like(x):
    """A zeroed pinned host copy of the shape and dtype of ``x`` (a
    tensor or a :class:`~..kernels.kv_quant.QuantArray`)."""
    if is_quantized(x):
        return QuantArray(_pinned_like(x.q), _pinned_like(x.scale))
    return torch.zeros(x.shape, dtype=x.dtype, pin_memory=True)


class _InBuf:
    """One graph kind's static int32 input buffer on the device, laid
    out as named fields of given widths (``temp`` and ``u`` hold f32
    bits): the buffer-driven device functions read their per-call values
    from it, so one CUDA graph per bucket serves every call.
    :meth:`load` fills it from a host buffer with one copy; fields not
    given are 0 (``NULL_BLOCK`` for a table)."""

    _F32 = frozenset(("temp", "u"))

    def __init__(self, device, **widths):
        self._at: Dict[str, Tuple[int, int]] = {}
        n = 0
        for name, w in widths.items():
            self._at[name] = (n, int(w))
            n += int(w)
        self._pin = device.type == "cuda"
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)

    def load(self, **values):
        """Copy ``values`` (name -> scalar or 1-D array) into the device
        buffer through a pinned host buffer, on the current stream."""
        h = torch.zeros(self.dev.shape, dtype=torch.int32,
                        pin_memory=self._pin)
        words = h.numpy()
        for name, v in values.items():
            lo, w = self._at[name]
            v = np.asarray(v).reshape(-1)
            dst = words.view(np.float32) if name in self._F32 else words
            dst[lo:lo + v.size] = v
        self.dev.copy_(h, non_blocking=True)

    def ints(self, name: str, n: Optional[int] = None) -> torch.Tensor:
        """The first ``n`` entries of a field (all by default), int64."""
        lo, w = self._at[name]
        return self.dev[lo:lo + (w if n is None else n)].long()

    def scalar(self, name: str) -> torch.Tensor:
        """A one-word field as a 0-d int64 device tensor (used in
        arithmetic only: a 0-d tensor as an index would sync)."""
        return self.dev[self._at[name][0]].long()

    def floats(self, name: str) -> torch.Tensor:
        lo, w = self._at[name]
        return self.dev[lo:lo + w].view(torch.float32)


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
                 "tokens", "error", "finish_reason", "stream_q",
                 "stream_notify", "t_submit", "t_first", "t_last",
                 "abandoned", "recoveries", "_lock", "_timeout_counted",
                 "trace", "qspan", "spec_rounds", "spec_proposed",
                 "spec_accepted", "spec_emitted", "spec_dt0", "spec_dt1",
                 "spec_vt0", "spec_vt1", "pipe_d0", "pipe_w0")

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
        # called after each stream put, so an event-loop consumer can
        # park on an event instead of a blocking get a stream; it must
        # never raise into the scheduler, so puts go through _stream_push.
        # A decode step's calls come at its end, and hooks with a
        # ``many`` attribute are called through it, once for all
        # (GenerationEngine._notify_deferred)
        self.stream_notify: Optional[Callable[[], None]] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.abandoned = False  # submitter gave up: skip, don't recount
        self.recoveries = 0     # recompute-recovery re-admissions
        self._lock = threading.Lock()
        self._timeout_counted = False
        self.trace = None   # a tracing.Trace when the request is traced
        self.qspan = None   # its open queue-wait span
        # a traced request's speculative rounds, summed so the terminal
        # trace can rebuild its draft and verify spans
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_dt0: Optional[float] = None
        self.spec_dt1: Optional[float] = None
        self.spec_vt0: Optional[float] = None
        self.spec_vt1: Optional[float] = None
        # the engine's cumulative decode-step span and sync wait when a
        # traced request became a decode lane; its step_pipeline span
        # reports the growth over its decode (engine-wide, as the batch
        # shares each step). None: never a decode lane of a pipelining
        # engine
        self.pipe_d0: Optional[float] = None
        self.pipe_w0: Optional[float] = None

    def _stream_push(self, item) -> None:
        self.stream_q.put(item)
        self._notify()

    def _notify(self) -> None:
        cb = self.stream_notify
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — the consumer's fault
                pass

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

    - ``speculation_k`` > 0 turns speculative decoding on (see the
      module doc; it forces ``decode_pipeline`` off, as in the JAX
      engine): ``draft_model`` shares the target's vocab and covers
      ``max_seq_len``, and defaults to
      :func:`~deeplearning4j_tpu_torch.zoo.transformer_lm.make_draft_lm`'s
      draft. Its cache is a dense f32 :class:`KVCache` whatever
      ``kv_dtype``, counted in ``metrics.cache_bytes``.

    - the hierarchical KV tier (see the module doc; paged backend with
      prefix sharing, else ``ValueError``): ``offload_host_bytes`` > 0
      turns demote-on-evict on with that host RAM budget,
      ``offload_disk_bytes`` > 0 adds the disk ring below it (a temp
      file unlinked at :meth:`stop`, or ``kv_ring.bin`` in
      ``offload_dir``), and ``offload_prefetch`` stages restores at
      submit time. With ``offload_host_bytes=0`` the other three do
      nothing, as in the JAX engine. :meth:`offload_sessions` demotes
      every session, :meth:`clear_offload` empties both tiers.

    The parameters take the JAX engine's positions and defaults.
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
        # speculative decoding: k = 0 is off (no draft, no propose graph,
        # the loop is the plain one)
        self.speculation_k = int(speculation_k)
        if self.speculation_k < 0:
            raise ValueError(f"speculation_k must be >= 0, "
                             f"got {speculation_k}")
        if self.speculation_k and \
                self.speculation_k + 1 >= self.max_seq_len:
            raise ValueError(
                f"speculation_k {self.speculation_k} leaves no room "
                f"under max_seq_len {self.max_seq_len}")
        self._vbucket = (verify_bucket(self.speculation_k)
                         if self.speculation_k else 0)
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
        self._init_offload(offload_host_bytes, offload_disk_bytes,
                           offload_dir)
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
        self._draft = None
        if self.speculation_k:
            self._init_speculation(draft_model)
        self.metrics.speculation_k = self.speculation_k
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
        # exists for A/B identity tests). Speculation forces it off, as
        # in JAX: a verify round needs the committed tokens on the host
        self.decode_pipeline = bool(decode_pipeline) \
            and not self.speculation_k
        # in-flight decode steps, oldest first (at most 2)
        self._pending: "collections.deque" = collections.deque()
        # lanes whose current token lives only on the device (the last
        # dispatched step's output); prefill refreshes the host mirror
        self._tok_on_dev = np.zeros(S, bool)
        # a request for each stream item whose notify waits for the end
        # of the decode step handing out tokens (None: notify at once)
        self._deferred: Optional[List[_GenRequest]] = None
        # the decode step (and with speculation the propose call) as a
        # CUDA graph (card only, captured at warmup or on the first call
        # after a hot one); replays add the launches the capture counted
        # to the kernels' counters. Set _cuda_graph False before warmup
        # for an engine with no graph at all (A/B and identity runs)
        self._cuda_graph = self.device.type == "cuda"
        self._graph = None
        self._graph_launches: Dict[str, int] = {}
        self._draft_graph = None
        self._draft_graph_launches: Dict[str, int] = {}
        self._draft_hot = False
        # -- the per-bucket graphs (graph_plan's keys but decode and
        # propose): the prefill (slots) or chunk (paged) buffers, the
        # copy-on-write ones, the graphs by key with the launches a
        # replay makes, and the keys that ran once (a key's second call
        # captures it in an engine never warmed). They share one memory
        # pool: they replay one at a time on one stream, and each
        # copies its results into its static output buffer
        if cache == "paged":
            self._pf_in = _InBuf(self.device, tok=self._chunk_cap, p0=1,
                                 clen=1, top_k=1, temp=1, u=1,
                                 table=self._tbl_top)
            self._cow_in = _InBuf(self.device, src=1, dst=1)
        else:
            self._pf_in = _InBuf(self.device, tok=self.prompt_buckets[-1],
                                 length=1, slot=1, top_k=1, temp=1, u=1)
        self._pf_out = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._graphs: Dict[tuple, Tuple[Any, Dict[str, int]]] = {}
        self._graph_hot: set = set()
        self._graph_pool = None
        self._capture_ms = 0.0  # wall time of every capture so far
        if self._offload is not None:
            # the offload graphs' buffers: the run's block index, and one
            # row buffer of the largest run bucket (every layer's K and V
            # at the pool dtype) that the gather writes and the scatter
            # reads, sliced per bucket; runs cross to and from the host
            # through one fixed staging buffer of the same shape, pinned
            # on the card (a demotion waits for its copy before numpy
            # reads it, a restore for its scatter before the next one
            # refills it). The host tier itself stays in pageable numpy
            top = self._off_buckets[-1]
            self._off_in = _InBuf(self.device, idx=top)
            shapes = self._cache.layer_shapes
            self._off_rows = tuple(
                [kv_zeros((top,) + sh, self.kv_dtype, self.device)
                 for sh in shapes] for _ in range(2))
            self._off_host = self._off_rows
            if self.device.type == "cuda":
                self._off_host = tuple(
                    [_pinned_like(r) for r in rows]
                    for rows in self._off_rows)
        if cache == "paged":
            self.metrics.block_size = self.block_size
            self.metrics.blocks_total = self._allocator.capacity
            self.metrics.prefix_sharing = self.enable_prefix_sharing
            self.metrics.offload_enabled = self._offload is not None
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
        # cumulative seconds from decode dispatch to results on the host,
        # and of them blocked in the sync: traced requests' step_pipeline
        # spans report the growth over their decode
        self._step_span_s = 0.0
        self._sync_wait_s = 0.0
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
        if self._offload is not None and offload_prefetch:
            self._offload_prefetcher = OffloadPrefetcher(self._stage_restore)
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
        # largest per-request table bucket, JAX's: the last chunk's
        # bucket can overshoot the allocation by < chunk_cap, and a
        # verify span's padded tail by < its bucket; the overshoot must
        # stay inside the table. Indexing past a table raises (JAX
        # clamped to the last entry, a real block), so an undersized
        # table fails loudly instead of aliasing live data
        self._tbl_top = pow2_bucket(blocks_for(
            self.max_seq_len + max(cap, self._vbucket), self.block_size))
        self._tbl_buckets = [1 << i for i in
                             range(self._tbl_top.bit_length())]
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

    def _init_offload(self, host_bytes, disk_bytes, offload_dir):
        """The hierarchical KV tier (JAX's knobs, checks and messages):
        the host store with its optional disk ring and the run buckets,
        the power-of-two ladder of the block tables up to
        ``pow2_bucket(blocks_per_seq)``. The prefetch thread starts with
        the scheduler, after every check."""
        self.offload_host_bytes = int(host_bytes)
        self._offload: Optional[HostBlockStore] = None
        self._offload_prefetcher: Optional[OffloadPrefetcher] = None
        self._off_buckets: List[int] = []
        if self.offload_host_bytes <= 0:
            return
        if self.cache_backend != "paged":
            raise ValueError("offload_host_bytes requires the "
                             "paged cache backend (cache='paged')")
        if not self.enable_prefix_sharing:
            raise ValueError(
                "offload_host_bytes requires prefix sharing "
                "(enable_prefix_sharing=True): restores re-enter "
                "the engine through session/prefix matching")
        disk = None
        if int(disk_bytes) > 0:
            path = (os.path.join(offload_dir, "kv_ring.bin")
                    if offload_dir else None)
            disk = DiskRing(int(disk_bytes), path=path)
        self._offload = HostBlockStore(self.offload_host_bytes, disk=disk)
        # a restore held for blocks: sid -> (run, operands or None, the
        # run's stamp, whether the prefetcher staged it)
        self._restore_parked: Dict[str, tuple] = {}
        top = pow2_bucket(self._blocks_per_seq)
        self._off_buckets = [b for b in self._tbl_buckets if b <= top]

    def _init_speculation(self, draft_model):
        """The draft (``make_draft_lm``'s by default), its dense f32
        cache, the draft-prime bucket ladder, the device functions of
        ``serving/speculative.py`` and the propose call's static
        buffers. The messages are the JAX engine's."""
        if draft_model is None:
            from ..zoo.transformer_lm import make_draft_lm
            draft_model = make_draft_lm(self.model)
        if getattr(draft_model, "_params", None) is None:
            draft_model.init()
        if draft_model.vocab_size != self.model.vocab_size:
            raise ValueError(
                f"draft vocab {draft_model.vocab_size} != target "
                f"vocab {self.model.vocab_size}: the draft must share "
                f"the target's tokenizer")
        if draft_model.max_seq_len < self.max_seq_len:
            raise ValueError(
                f"draft position table ({draft_model.max_seq_len})"
                f" shorter than max_seq_len {self.max_seq_len}")
        if draft_model.device.type != self.device.type:
            raise ValueError(f"draft model on {draft_model.device}, "
                             f"target on {self.device}")
        self._draft = draft_model
        # f32 whatever kv_dtype: the draft cache is small, and its
        # tensors' addresses are what the propose graph captures, so it
        # is zeroed in place (_reset_draft_cache), never reallocated
        self._draft_cache = KVCache(
            draft_model.cache_shapes(self.max_seq_len), self.num_slots,
            kv_dtype="f32", device=self.device)
        self.metrics.cache_bytes += self._draft_cache.nbytes()
        # draft-prime ladder: pow2 steps topped by max_seq_len itself
        # (the draft cache is exactly max_seq_len deep, and a prime slab
        # must fit it)
        self._prime_buckets = []
        b = self.min_prompt_bucket
        while b < self.max_seq_len:
            self._prime_buckets.append(b)
            b <<= 1
        self._prime_buckets.append(self.max_seq_len)
        self._prime_fn = make_prime_fn(draft_model)
        self._propose_fn = make_propose_fn(draft_model, self.speculation_k)
        self._verify_fn = (make_verify_paged_fn
                           if self.cache_backend == "paged"
                           else make_verify_slots_fn)(self.model)
        S = self.num_slots
        # the propose call reads [token, pos] per lane and writes
        # [proposals..., ok] per lane: static, so one graph replays them
        self._prop_in = torch.zeros((2, S), dtype=torch.int64,
                                    device=self.device)
        self._prop_out = torch.zeros((S, self.speculation_k + 1),
                                     dtype=torch.int64, device=self.device)
        # the prime graphs' buffers (tokens, length, slot -> ok) and the
        # verify graphs' (a span, its p0, width and slot or table, the
        # lane's sampling and one uniform a row -> tgt, n_acc, ok)
        self._prime_in = _InBuf(self.device, tok=self._prime_buckets[-1],
                                length=1, slot=1)
        self._prime_out = torch.zeros(1, dtype=torch.int64,
                                      device=self.device)
        vb = self._vbucket
        where = (dict(table=self._tbl_top) if self.cache_backend == "paged"
                 else dict(slot=1))
        self._verify_in = _InBuf(self.device, tok=vb, p0=1, vlen=1,
                                 top_k=1, temp=1, u=vb, **where)
        self._verify_out = torch.zeros(vb + 2, dtype=torch.int64,
                                       device=self.device)

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
        off = self._offload
        if off is not None:
            s = off.stats()
            m = self.metrics
            m.offload_host_runs = s["host_runs"]
            m.offload_host_blocks = s["host_blocks"]
            m.offload_host_bytes = s["host_bytes"]
            m.offload_disk_blocks = s["disk_blocks"]
            m.offload_disk_bytes = s["disk_bytes"]
            m.offload_spills = s["spills"]
            m.offload_drops = s["drops"]

    # -- device calls ----------------------------------------------------
    # The buffer-driven device functions: each reads its per-call values
    # from its kind's static input buffer and writes its results into
    # its static output buffer, so that one CUDA graph per bucket (the
    # JAX engine's executable) replays it; on the CPU, with
    # ``_cuda_graph`` off and at a cold key's first call they run
    # eagerly, the same function. They take the caches to write, so
    # warmup runs them on scratch ones.
    def _sample_row(self, row, buf: _InBuf):
        """Sample generation token #1 from ``row`` [1, V] at the
        uniform of the step-0 fold the host put in ``buf``."""
        return _sample_from_logits(row, buf.floats("temp"),
                                   buf.ints("top_k"), buf.floats("u"))

    def _prefill_fn(self, kcs, vcs, bucket: int):
        """One prompt pass at ``bucket`` (JAX's ``_prefill_fn``): the K/V
        slab written into the slot's cache row in place, token #1
        sampled from row ``length - 1``; [token, logits all finite]
        into ``_pf_out``. Positions past ``length`` get the padded
        tail's K/V: masked by the length, and overwritten as decode
        advances."""
        buf = self._pf_in
        length = buf.scalar("length")
        slot = buf.ints("slot")
        key_mask = (torch.arange(bucket, device=self.device)[None]
                    < length).to(torch.float32)
        logits, ks, vs = self.model.forward_prefill(
            self.model._params, buf.ints("tok", bucket)[None], key_mask)
        # padded rows only see keys under key_mask, so a non-finite
        # value traces back to the request's own tokens
        ok = torch.isfinite(logits).all()
        for kc, k in zip(kcs, ks):
            kv_update_slice(kc, k, (slot, 0, 0, 0))
        for vc, v in zip(vcs, vs):
            kv_update_slice(vc, v, (slot, 0, 0, 0))
        first = self._sample_row(
            logits[0].index_select(0, (length - 1).reshape(1)), buf)
        self._pf_out.copy_(torch.cat([first, ok.long().reshape(1)]))

    def _chunk_fn(self, kcs, vcs, bucket: int, tbl: int):
        """One prefill chunk of ``bucket`` rows through a table of
        ``tbl`` blocks on the paged pool (JAX's ``_chunk_fn``): K/V
        written into the request's blocks in place, row ``clen - 1``
        sampled at the step-0 fold (used only on the final chunk);
        [token, the valid rows' logits all finite] into ``_pf_out``."""
        buf = self._pf_in
        clen = buf.scalar("clen")
        logits, _, _ = self.model.forward_prefill_chunk(
            self.model._params, buf.ints("tok", bucket)[None],
            buf.scalar("p0"), clen, kcs, vcs, buf.ints("table", tbl))
        # guard only rows < clen: padded rows attend positions past the
        # live length, stale junk that may be anything
        rows = torch.arange(bucket, device=self.device)
        ok = torch.where((rows < clen)[:, None], torch.isfinite(logits),
                         True).all()
        first = self._sample_row(
            logits.index_select(0, (clen - 1).reshape(1)), buf)
        self._pf_out.copy_(torch.cat([first, ok.long().reshape(1)]))

    def _cow_fn(self, kcs, vcs):
        """Copy pool block ``src`` into ``dst`` (every layer, K and V,
        an int8 pool's scale rows with its values)."""
        src, dst = self._cow_in.ints("src"), self._cow_in.ints("dst")
        for pool in kcs + vcs:
            kv_copy_row(pool, src, dst)

    def _offload_save_fn(self, kcs, vcs, bucket: int):
        """Gather the pool rows the first ``bucket`` entries of
        ``_off_in`` name (every layer, K and V, an int8 pool's scale
        rows with its values) into the leading rows of the row buffer:
        a demotion's device half, which leaves the pools untouched."""
        export_block_run(kcs, vcs, self._off_in.ints("idx", bucket),
                         out=self._off_rows)

    def _offload_load_fn(self, kcs, vcs, bucket: int):
        """Scatter the row buffer's leading ``bucket`` rows into the pool
        rows ``_off_in`` names, in place: a restore's device half.
        Padded entries name the null block."""
        import_block_run(kcs, vcs, *self._off_rows,
                         self._off_in.ints("idx", bucket))

    def _prime_graph_fn(self, kcs, vcs, bucket: int):
        """The draft prime at ``bucket`` into the draft cache; its ok
        into ``_prime_out``."""
        buf = self._prime_in
        ok = self._prime_fn(self._draft._params, kcs, vcs,
                            buf.ints("tok", bucket)[None],
                            buf.scalar("length"), buf.ints("slot"))
        self._prime_out.copy_(ok.long().reshape(1))

    def _verify_graph_fn(self, kcs, vcs, tbl: Optional[int]):
        """One verify span (through a table of ``tbl`` blocks on the
        paged backend, on the slot's panel on the slot one); [tgt...,
        n_accepted, ok] into ``_verify_out``."""
        buf = self._verify_in
        where = (buf.ints("table", tbl) if tbl is not None
                 else buf.ints("slot"))
        tgt, n_acc, ok = self._verify_fn(
            self.model._params, kcs, vcs,
            buf.ints("tok")[None], buf.scalar("p0"), buf.scalar("vlen"),
            where, buf.floats("u"), buf.floats("temp"), buf.ints("top_k"))
        self._verify_out.copy_(torch.cat([tgt, n_acc.reshape(1),
                                          ok.long().reshape(1)]))

    def _graph_run(self, key: tuple) -> Callable[[], None]:
        """The device function of one :meth:`graph_plan` key (but decode
        and propose) on the engine's own caches: what its graph
        captures, and what runs eagerly where there is none."""
        kind = key[0]
        if kind == "prefill":
            return lambda: self._prefill_fn(self._kcs, self._vcs, key[1])
        if kind == "chunk":
            return lambda: self._chunk_fn(self._kcs, self._vcs, key[1],
                                          key[2])
        if kind == "cow":
            return lambda: self._cow_fn(self._kcs, self._vcs)
        if kind == "offload_save":
            return lambda: self._offload_save_fn(self._kcs, self._vcs,
                                                 key[1])
        if kind == "offload_load":
            return lambda: self._offload_load_fn(self._kcs, self._vcs,
                                                 key[1])
        if kind == "prime":
            return lambda: self._prime_graph_fn(
                self._draft_cache.ks, self._draft_cache.vs, key[1])
        if kind == "verify":
            return lambda: self._verify_graph_fn(
                self._kcs, self._vcs, key[1] if len(key) > 1 else None)
        raise ValueError(f"no device function for {key!r}")

    def _device_call(self, key: tuple, buf: _InBuf, out=None, **values):
        """One call of ``key``'s device function: ``values`` into its
        input buffer, then its graph's replay (captured here at a cold
        key's second call), or the function eagerly; ``out`` comes back
        to the host behind one event. Returns (the results as numpy or
        None, whether this call captured)."""
        captured = False
        if self._cuda_graph and key not in self._graphs \
                and key in self._graph_hot:
            self._capture_graph(key)
            captured = True
        buf.load(**values)
        graph = self._graphs.get(key)
        if graph is not None:
            graph[0].replay()
            add_launches(graph[1])
        else:
            self._graph_run(key)()
        self._graph_hot.add(key)
        return (None if out is None else self._fetch(out)), captured

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        """A static output buffer on the host: one pinned copy behind an
        event, the call's one sync."""
        h = self._host(out.shape, out.dtype)
        h.copy_(out, non_blocking=True)
        self._sync()
        return h.numpy()

    def _sync(self):
        """Wait for everything queued on the current stream (one event;
        nothing on the CPU)."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    def _prefill_call(self, tokens: np.ndarray, length: int, slot: int,
                      req: _GenRequest):
        """One prompt pass at its bucket into ``slot``. Returns (first
        token, logits all finite, whether the call captured)."""
        bucket = tokens.shape[1]
        out, cold = self._device_call(
            ("prefill", bucket), self._pf_in, self._pf_out, tok=tokens[0],
            length=length, slot=slot, top_k=req.top_k,
            temp=req.temperature, u=self._first_uniform(req))
        return int(out[0]), bool(out[1]), cold

    def _chunk_call(self, tokens: np.ndarray, p0: int, clen: int,
                    table: np.ndarray, req: _GenRequest):
        """One prefill chunk through ``table`` (its bucket's width).
        Returns (the row ``clen - 1`` token, the valid rows' logits all
        finite, whether the call captured)."""
        out, cold = self._device_call(
            ("chunk", tokens.shape[1], len(table)), self._pf_in,
            self._pf_out, tok=tokens[0], p0=p0, clen=clen, table=table,
            top_k=req.top_k, temp=req.temperature,
            u=self._first_uniform(req))
        return int(out[0]), bool(out[1]), cold

    @staticmethod
    def _first_uniform(req: _GenRequest) -> float:
        """The uniform of token #1 (the step-0 fold); 0 for a greedy
        request, which ignores it."""
        if req.temperature <= 0:
            return 0.0
        return float(_uniforms(np.array([req.seed], np.uint32),
                               np.zeros(1, np.int32))[0])

    def _cow(self, src: int, dst: int):
        """Copy pool block ``src`` into ``dst`` (every layer, K and V)
        so the admitted request writes into its private copy while
        every other reader of ``src`` sees it bit-unchanged."""
        with self._profiler.record("generation.cow"):
            self._device_call(("cow",), self._cow_in, src=src, dst=dst)

    # -- the hierarchical KV tier (serving/offload.py) -------------------
    # A demotion gathers a block run device -> host, a restore scatters
    # it back: the offload graphs of one power-of-two run bucket over the
    # index buffer and the row buffer, so no offload traffic captures
    # after warmup and the pools keep their storage.
    def _run_index(self, blocks: List[int]) -> Tuple[int, np.ndarray]:
        """A run's bucket and its block index, NULL-padded to it."""
        bucket = pow2_bucket(len(blocks))
        idx = np.full(bucket, NULL_BLOCK, np.int32)
        idx[:len(blocks)] = blocks
        return bucket, idx

    def _export_run(self, tokens: np.ndarray, blocks: List[int]) -> HostRun:
        """Device half of a demotion: gather the run's pool rows (every
        layer, K and V) into the row buffer, bring its first
        ``len(blocks)`` rows to the staging buffer behind one event, and
        copy them into host arrays of their own at the pool dtype. On
        return the source blocks may be freed and the buffers reused."""
        n = len(blocks)
        bucket, idx = self._run_index(blocks)
        with self._profiler.record("generation.offload_demote"):
            self._device_call(("offload_save", bucket), self._off_in,
                              idx=idx)
            for dev, host in zip(self._off_rows, self._off_host):
                if host is dev:
                    continue
                for d, h in zip(dev, host):
                    for dt, ht in zip(kv_tensors(d), kv_tensors(h)):
                        ht[:n].copy_(dt[:n], non_blocking=True)
            self._sync()
            ks, vs = ([kv_pack_host(r, n) for r in rows]
                      for rows in self._off_host)
        return HostRun(tokens, ks, vs, self.kv_dtype)

    def _build_restore_ops(self, run: HostRun, bucket: int):
        """A run's packed layers as host tensors at the pool dtype,
        zero-padded to ``bucket`` rows: the scatter's operands. Host
        work only, the half a prefetch overlaps with the queue wait."""
        return ([kv_unpack_host(layer, bucket) for layer in run.ks],
                [kv_unpack_host(layer, bucket) for layer in run.vs])

    def _import_run(self, run: HostRun, blocks: List[int], ops=None):
        """Device half of a restore: the operands through the staging
        buffer into the row buffer, then the scatter into the freshly
        allocated ``blocks``, in place, and one sync that surfaces a
        device fault. Raises whatever the device call raises: the pools
        may be written part way, so the CALLER maps a failure to
        recompute-recovery."""
        bucket, idx = self._run_index(blocks)
        if ops is None:
            ops = self._build_restore_ops(run, bucket)
        with self._profiler.record("generation.offload_restore"):
            for src, dev, host in zip(ops, self._off_rows, self._off_host):
                for o, d, h in zip(src, dev, host):
                    for ot, dt, ht in zip(kv_tensors(o), kv_tensors(d),
                                          kv_tensors(h)):
                        ht[:bucket].copy_(ot)
                        if ht is not dt:
                            dt[:bucket].copy_(ht[:bucket], non_blocking=True)
            self._device_call(("offload_load", bucket), self._off_in,
                              idx=idx)
            self._sync()

    def _demote_session(self, sess) -> bool:
        """Copy an evicted session's block run to the host tier (the
        caller still frees the device blocks). Any failure, the
        ``offload_io`` seam or a real gather error, degrades to a plain
        discard: the gather leaves the device tier untouched."""
        off = self._offload
        sid = sess.session_id
        if off is None or sid is None:
            return False
        t0 = time.perf_counter()
        try:
            self._hit("offload_io")
            run = self._export_run(sess.tokens, sess.blocks)
        except Exception:  # noqa: BLE001 — torn demotion -> discard
            self.metrics.inc("offload_demote_failures")
            return False
        off.put(sid, run)
        self.metrics.inc("offload_demotions")
        self.metrics.offload_demote_ms.record(
            (time.perf_counter() - t0) * 1e3)
        return True

    def _demote_prefix(self, digest: bytes, block: int) -> bool:
        """Demote one evicted prefix-index block under its chained
        digest (``px:<hex>``): an admission whose prompt hashes to the
        same chain restores it instead of re-prefilling it."""
        off = self._offload
        if off is None:
            return False
        try:
            self._hit("offload_io")
            run = self._export_run(np.zeros(0, np.int32), [block])
        except Exception:  # noqa: BLE001 — torn demotion -> discard
            self.metrics.inc("offload_demote_failures")
            return False
        off.put("px:" + digest.hex(), run)
        self.metrics.inc("offload_demotions")
        return True

    def _stage_restore(self, key: str):
        """The prefetch thread's stage: read the run (RAM or disk) and
        build its padded host operands. Host memory only: the allocator,
        the staging buffers and every device call stay on the scheduler
        thread."""
        off = self._offload
        if off is None:
            return None
        stamp = off.stamp(key)
        run = off.get(key)
        if run is None:
            return None
        return (run, self._build_restore_ops(run, pow2_bucket(run.n_blocks)),
                stamp)

    def _offload_restore(self, req: "_GenRequest") -> Optional[bool]:
        """The restore-or-re-prefill decision of one admission: a demoted
        session's run scatters back into freshly allocated blocks and is
        pinned again, so :meth:`_match_prefix` finds a session hit and
        the turn pays only its suffix prefill. Falls back to the plain
        path (False: a full prefill) on no host copy, a token mismatch,
        a pool too small for the run even with nothing in flight, or a
        torn restore (the ``offload_io`` seam). None: the run waits for
        blocks that in-flight requests hold, and the caller holds the
        request at the head of the line (the JAX engine re-prefills
        there instead, which under a burst re-prefills sessions the host
        tier still holds). Only a REAL scatter failure escapes, as
        :class:`CorruptedStateFault`: the pools may be written part
        way."""
        off = self._offload
        if off is None or req.tokens or req.session_id is None:
            return False
        sid = req.session_id
        if sid in self._sessions:
            return False  # the device pin is current; a host copy stale
        pf = self._offload_prefetcher
        # what an attempt held for blocks read, else the prefetch's stage
        staged = self._restore_parked.pop(sid, None)
        if staged is None and pf is not None:
            got = pf.take(sid)
            staged = None if got is None else got + (True,)
        run = ops = None
        prefetched = False
        if staged is not None:
            run, ops, stamp, prefetched = staged
            if stamp is None or off.stamp(sid) != stamp:
                # re-demoted (or popped) since: stale operands. A run
                # spilled to disk since is still current (the JAX
                # engine's RAM-only identity check drops it)
                run = ops = None
                prefetched = False
        if run is None:
            stamp = off.stamp(sid)
            run = off.get(sid)
            if run is None:
                return False
        # the session branch of _match_prefix's rule: the stored turn
        # must prefix-match the prompt
        prompt = req.prompt
        stored = run.tokens
        n = min(len(stored), len(prompt) - 1)
        neq = stored[:n] != prompt[:n]
        m = int(np.argmax(neq)) if neq.any() else n
        if m <= 0:
            return False
        try:
            self._hit("offload_io")
        except (TransientFault, CorruptedStateFault):
            # torn restore: drop the host copy and re-prefill; no device
            # call ran, nothing to corrupt
            off.pop(sid)
            if pf is not None:
                pf.discard(sid)
            self.metrics.inc("offload_restore_failures")
            return False
        blocks = self._alloc_with_eviction(run.n_blocks)
        if blocks is None:
            if self._allocator.used_count <= self._reclaimable():
                # nothing in flight to wait for: the pool cannot hold
                # the run, re-prefill
                return False
            # the next attempt reuses what this one read (no disk read or
            # operand build on the scheduler thread at every retry)
            self._restore_parked = {sid: (run, ops, stamp, prefetched)}
            return None
        t0 = time.perf_counter()
        try:
            self._import_run(run, blocks, ops)
        except Exception as e:  # noqa: BLE001 — the pools may be written
            raise CorruptedStateFault(
                f"offload restore device call failed: {e!r}") from e
        evictions = 0
        for old in self._sessions.put(sid, run.tokens, list(blocks)):
            if old.session_id != sid:
                self._demote_session(old)
                evictions += 1
            self._allocator.free(old.blocks)
        if evictions:
            self.metrics.inc("session_evictions", evictions)
        off.pop(sid)
        self.metrics.inc("offload_restores")
        if prefetched:
            self.metrics.inc("offload_prefetch_hits")
        self.metrics.offload_restore_ms.record(
            (time.perf_counter() - t0) * 1e3)
        if req.trace is not None:
            req.trace.span("offload_restore", tokens=len(stored),
                           blocks=run.n_blocks, prefetched=prefetched).end()
        return True

    def _restore_prefix_blocks(self, req: "_GenRequest"):
        """Restore the demoted PREFIX blocks the prompt's chained hashes
        name, before :meth:`_match_prefix`, so the index matches them as
        usual; stops at the first digest in neither the index nor the
        host tier (the chain breaks there)."""
        off = self._offload
        if off is None or req.tokens or not self.enable_prefix_sharing:
            return
        if req.session_id is not None and req.session_id in self._sessions:
            return  # the session pin already covers the prefix
        hashes = chain_hashes(req.prompt, self.block_size)
        # the chain's own entries are never evicted for its restores (the
        # JAX engine evicts the LRU entry, under pressure the chain's
        # first, so restoring block i demoted block i - k at every
        # admission attempt)
        chain = frozenset(hashes)
        for h in hashes:
            if self._prefix_index.match([h]):
                continue
            key = "px:" + h.hex()
            run = off.get(key)
            if run is None:
                return
            try:
                self._hit("offload_io")
            except (TransientFault, CorruptedStateFault):
                off.pop(key)
                self.metrics.inc("offload_restore_failures")
                return
            blocks = self._alloc_with_eviction(1, protect=chain)
            if blocks is None:
                return
            try:
                self._import_run(run, blocks)
            except Exception as e:  # noqa: BLE001 — the pools may be
                # written
                raise CorruptedStateFault(
                    f"offload prefix restore device call failed: "
                    f"{e!r}") from e
            self._prefix_index.register(h, blocks[0])
            off.pop(key)
            self.metrics.inc("offload_restores")

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

    def _run_propose(self):
        """The draft's k-step proposal from ``_prop_in`` into
        ``_prop_out`` (what the propose graph captures)."""
        k = self.speculation_k
        props, ok = self._propose_fn(self._draft._params,
                                     self._draft_cache.ks,
                                     self._draft_cache.vs,
                                     self._prop_in[0], self._prop_in[1])
        self._prop_out[:, :k].copy_(props)
        self._prop_out[:, k].copy_(ok)

    def _capture(self, run: Callable[[], None], what: str,
                 shared: bool = False):
        """Capture ``run`` into a CUDA graph (counted in
        ``metrics.compiles``, its wall time in ``_capture_ms``), with
        ``shared`` in the memory pool the per-bucket graphs share, else
        in a pool of its own (:func:`.engine.capture_graph`). A failed
        capture raises. Returns (graph, the launches one replay
        makes)."""
        if shared and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        pool = self._graph_pool if shared else None
        t0 = time.perf_counter()
        try:
            graph, _, counted = capture_graph(
                run, f"{what} ({self.cache_backend}, {self.kv_dtype})",
                pool)
        finally:
            self._capture_ms += (time.perf_counter() - t0) * 1e3
        self.metrics.inc("compiles")
        return graph, counted

    def _capture_graph(self, key: tuple):
        """Capture one :meth:`graph_plan` key's graph (but decode and
        propose) in the pool the per-bucket graphs share."""
        self._graphs[key] = self._capture(self._graph_run(key),
                                          f"the {key} call", shared=True)

    def _capture_decode_graph(self):
        self._graph, self._graph_launches = self._capture(
            self._run_decode_step, "the decode step")

    def _capture_draft_graph(self):
        self._draft_graph, self._draft_graph_launches = self._capture(
            self._run_propose, "the draft's proposal")

    def _host(self, shape, dtype) -> torch.Tensor:
        """A host buffer for one step's copies: pinned on the card (the
        caching host allocator reuses it only after its copies' events),
        plain memory on the CPU."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _dispatch_decode(self, skip=frozenset()) -> bool:
        """Launch one decode step without waiting for it: the inputs go
        from a pinned buffer of the step's own into the static input
        buffer, the step runs (the graph's replay, or eagerly), and its
        [next token, ok, done] go into a pinned buffer of the step's own,
        all on the current stream; an event marks the step's end. Each
        stepped lane's current token then lives on the device (fed to
        the next step from the output buffer), and pos and step advance
        on the host at once. Returns False when no lane is ready.

        ``skip`` holds the lanes a speculative round advanced this
        iteration: they ride the step as passengers (the batch is the
        full slot panel either way), fed their committed token from the
        host; their one K/V write lands at the position their next
        verify span or decode step rewrites before reading it, and
        their results are not applied."""
        st = self._slots
        active = [s for s in self._ready_slots() if s not in skip]
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
            self._step_span_s += span_s
            self._sync_wait_s += wait_s
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
            self._deferred = []
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
            self._notify_deferred()
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

    def _warm_buckets(self, buckets: Optional[Sequence[int]]) -> List[int]:
        """The prompt (slots) or chunk (paged) buckets to warm: all of
        the ladder by default; one outside it raises."""
        paged = self.cache_backend == "paged"
        ladder = self.chunk_buckets if paged else self.prompt_buckets
        buckets = sorted(set(int(x) for x in (buckets or ladder)))
        for b in buckets:
            if b not in ladder:
                raise ValueError(
                    f"bucket {b} not in "
                    f"{'chunk_buckets' if paged else 'prompt_buckets'} "
                    f"{ladder}")
        return buckets

    def graph_plan(self, buckets: Optional[Sequence[int]] = None
                   ) -> List[tuple]:
        """The keys of the CUDA graphs :meth:`warmup` captures on the
        card: one per executable the JAX engine's ``warmup`` compiles
        for the same configuration.
        ``("decode",)``; slots: ``("prefill", b)`` per prompt bucket;
        paged: ``("cow",)`` with prefix sharing, ``("offload_save",
        b)`` and ``("offload_load", b)`` per run bucket ``b`` with the
        KV tier on, and ``("chunk", c, t)`` per chunk bucket ``c`` and
        table bucket ``t`` with ``t * block_size >= c``; with
        speculation ``("propose",)``,
        ``("prime", b)`` per prime bucket and one ``("verify",)``
        (slots) or ``("verify", t)`` per table bucket with ``t *
        block_size`` >= the verify bucket (paged). ``buckets`` narrows
        the prompt or chunk buckets, as :meth:`warmup`'s does."""
        buckets = self._warm_buckets(buckets)
        plan = [("decode",)]
        if self.cache_backend == "paged":
            bs = self.block_size
            if self.enable_prefix_sharing:
                plan.append(("cow",))
            plan += [(kind, b) for b in self._off_buckets
                     for kind in ("offload_save", "offload_load")]
            plan += [("chunk", c, t) for c in buckets
                     for t in self._tbl_buckets if t * bs >= c]
        else:
            plan += [("prefill", b) for b in buckets]
        if self.speculation_k:
            plan.append(("propose",))
            plan += [("prime", b) for b in self._prime_buckets]
            if self.cache_backend == "paged":
                plan += [("verify", t) for t in self._tbl_buckets
                         if t * self.block_size >= self._vbucket]
            else:
                plan.append(("verify",))
        return plan

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Run every prefill bucket (paged: every chunk bucket, the
        copy-on-write copy and every offload run bucket's gather and
        scatter), one decode step and, with speculation,
        every draft-prime bucket, one proposal and one verify span once,
        on the scheduler thread and on scratch caches, so the first
        requests pay no one-time costs (kernel build and load, library
        handles); then, on the card, capture every graph of
        :meth:`graph_plan` (the JAX engine's warm set): traffic then
        replays them and captures nothing, recoveries included. A failed
        capture raises; nothing runs eagerly instead. Returns the warmed
        bucket list."""
        paged = self.cache_backend == "paged"
        plan = self.graph_plan(buckets)
        buckets = self._warm_buckets(buckets)

        def job():
            dev, model = self.device, self.model
            kv = self.kv_dtype
            if paged:
                bs = self.block_size
                # null block + one block; the tables the buffer holds are
                # all NULL, and so is every scratch decode lane's
                scratch = PagedKVCache(model.cache_shapes(bs), 2,
                                       kv_dtype=kv, device=dev)
                for c in buckets:
                    self._pf_in.load(clen=c)
                    self._chunk_fn(scratch.ks, scratch.vs, c,
                                   pow2_bucket(blocks_for(c, bs)))
                    self._hot_buckets.add(c)
                if self.enable_prefix_sharing:
                    self._cow_in.load(src=0, dst=1)
                    self._cow_fn(scratch.ks, scratch.vs)
                if self._offload is not None:
                    # every run bucket's gather and scatter, through the
                    # null block (an index buffer of zeros)
                    self._off_in.load()
                    for b in self._off_buckets:
                        self._offload_save_fn(scratch.ks, scratch.vs, b)
                        self._offload_load_fn(scratch.ks, scratch.vs, b)
                span = scratch
            else:
                span = KVCache(model.cache_shapes(self.max_seq_len), 1,
                               kv_dtype=kv, device=dev)
                for b in buckets:
                    self._pf_in.load(length=b)
                    self._prefill_fn(span.ks, span.vs, b)
                    self._hot_buckets.add(b)
                # every lane decodes position 0 of a one-position slot
                scratch = KVCache(model.cache_shapes(1), self.num_slots,
                                  kv_dtype=kv, device=dev)
            self._decode_step_fn(scratch.ks, scratch.vs,
                                 torch.zeros_like(self._step_in),
                                 torch.zeros_like(self._step_out))
            draft = self._draft
            if draft is not None:
                primed = KVCache(draft.cache_shapes(self.max_seq_len), 1,
                                 device=dev)
                for b in self._prime_buckets:
                    self._prime_in.load(length=b)
                    self._prime_graph_fn(primed.ks, primed.vs, b)
                # every lane proposes at position 0 of a one-position slot
                scratch = KVCache(draft.cache_shapes(1), self.num_slots,
                                  device=dev)
                self._propose_fn(draft._params, scratch.ks, scratch.vs,
                                 torch.zeros_like(self._prop_in[0]),
                                 torch.zeros_like(self._prop_in[1]))
                self._verify_in.load(vlen=1)
                self._verify_graph_fn(span.ks, span.vs, next(
                    t for t in self._tbl_buckets
                    if t * self.block_size >= self._vbucket)
                    if paged else None)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._decode_hot = True
            self._draft_hot = draft is not None
            if self._cuda_graph:
                if self._graph is None:
                    self._capture_decode_graph()
                if draft is not None and self._draft_graph is None:
                    self._capture_draft_graph()
                # largest buckets first: a smaller graph's capture then
                # reuses the shared pool's blocks instead of growing it
                for key in sorted(plan, key=lambda k: [-x for x in k[1:]]):
                    if key[0] not in ("decode", "propose") \
                            and key not in self._graphs:
                        self._capture_graph(key)
            self._graph_hot.update(plan)

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
                 session_id: Optional[str] = None,
                 trace=None) -> Dict[str, Any]:
        """Blocking generate: returns ``{"tokens", "prompt_tokens",
        "finish_reason"}``. Raises :class:`ClientError`,
        :class:`QueueFullError`, :class:`DeadlineExceededError`,
        :class:`PoisonRequestError`, the error its own prefill call
        raised, or :class:`ServingError` when the fault ladder gave it
        up (see the module doc). ``trace`` (a :class:`~..tracing.Trace`,
        default ``None``: untraced) records the request's spans (see the
        module doc)."""
        req = self._submit(prompt, max_tokens, temperature, top_k, seed,
                           eos_id, timeout_ms, stream=False,
                           priority=priority, session_id=session_id,
                           trace=trace)
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
               session_id: Optional[str] = None,
               trace=None) -> Iterator[Dict]:
        """Streaming generate: yields ``{"token", "index"}`` per token,
        then ``{"done": True, "finish_reason", ...}``. Admission errors
        raise here; later failures raise from the iterator. ``trace`` as
        in :meth:`generate`."""
        req = self._submit(prompt, max_tokens, temperature, top_k, seed,
                           eos_id, timeout_ms, stream=True,
                           priority=priority, session_id=session_id,
                           trace=trace)
        return _TokenStream(self, req)

    def _submit(self, *args, trace=None, **kw) -> _GenRequest:
        """Validate and enqueue, counting pre-admission 5xx here. A
        traced request's ``admission`` span and open ``queue`` span are
        attached before the enqueue: the scheduler may admit it at
        once."""
        t0 = time.perf_counter()
        try:
            req = self._make_request(*args, **kw)
            if trace is not None:
                req.trace = trace
                trace.span(
                    "admission", t_start=t0, verdict="admitted",
                    est_cost_ms=round(self._est_cost_ms(
                        len(req.prompt), req.max_tokens), 3),
                    prefill_ms_per_tok=round(self._prefill_ms_per_tok, 4),
                    decode_ewma_ms=round(self._decode_ewma_ms, 3)).end()
                req.qspan = trace.span("queue", priority=req.priority)
            pf = self._offload_prefetcher
            if (pf is not None and req.session_id is not None
                    and req.session_id not in self._sessions
                    and req.session_id in self._offload):
                # stage the demoted run (a disk read, the padded host
                # operands) while the request waits in the queue; the
                # scheduler re-checks staleness when it takes them, so
                # this racy glance at its session store is safe
                pf.request(req.session_id)
            self._enqueue(req)
            return req
        except (ClientError, QueueFullError, DeadlineExceededError) as e:
            if trace is not None:
                trace.span(
                    "admission", t_start=t0, verdict="shed", error=str(e),
                    prefill_ms_per_tok=round(self._prefill_ms_per_tok, 4),
                    decode_ewma_ms=round(self._decode_ewma_ms, 3)).end()
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

    def _trace_terminal(self, req: _GenRequest, reason=None, exc=None):
        """A traced request's terminal spans, built from what the engine
        keeps (``t_first``/``t_last``, the token count, the recoveries,
        the pipeline counters, the speculation sums), so the decode loop
        carries no tracing code: ``decode`` (``error`` for a request that
        never emitted), ``step_pipeline`` over its decode lifetime, and
        one ``draft`` and one ``verify`` span over its speculative
        rounds."""
        tr = req.trace
        if tr is None:
            return
        if req.qspan is not None:
            req.qspan.end()  # idempotent: shed before its claim
        attrs = {"steps": len(req.tokens), "recoveries": req.recoveries}
        if reason is not None:
            attrs["finish_reason"] = reason
        if exc is not None:
            attrs["error"] = repr(exc)
            if isinstance(exc, PoisonRequestError):
                attrs["quarantined"] = True
        if req.t_first is not None:
            end = req.t_last if req.t_last is not None else req.t_first
            tr.span("decode", t_start=req.t_first, t_end=end, **attrs)
        else:
            tr.span("error" if exc is not None else "decode", **attrs).end()
        if req.pipe_d0 is not None and self._step_span_s > req.pipe_d0:
            # engine-wide over the request's decode: every lane shares a
            # step's dispatch and sync; the gap between the two is host
            # work that overlapped the device
            dev_s = self._step_span_s - req.pipe_d0
            wait_s = self._sync_wait_s - req.pipe_w0
            tr.span("step_pipeline", device_ms=round(dev_s * 1e3, 3),
                    sync_wait_ms=round(wait_s * 1e3, 3),
                    overlap_frac=round(max(0.0, 1.0 - wait_s / dev_s),
                                       4)).end()
        if req.spec_rounds:
            rate = round(req.spec_accepted / max(req.spec_proposed, 1), 4)
            tr.span("draft", t_start=req.spec_dt0, t_end=req.spec_dt1,
                    rounds=req.spec_rounds, proposed=req.spec_proposed)
            tr.span("verify", t_start=req.spec_vt0, t_end=req.spec_vt1,
                    rounds=req.spec_rounds, proposed=req.spec_proposed,
                    accepted=req.spec_accepted, accept_rate=rate,
                    spec_tokens=req.spec_emitted,
                    saved_est_ms=round(
                        max(req.spec_emitted - req.spec_rounds, 0)
                        * self._decode_ewma_ms, 3))

    def _fail(self, req: _GenRequest, exc: BaseException,
              count: bool = True):
        """``count=False`` for shutdown drains: a restart is not an
        outage."""
        req.error = exc
        if isinstance(exc, DeadlineExceededError):
            req.count_timeout_once(self.metrics)
        elif count and not isinstance(exc, ClientError):
            self.metrics.inc("server_errors")
        self._trace_terminal(req, exc=exc)
        if req.stream_q is not None:
            self._push(req, ("error", exc))
        req.event.set()

    def _push(self, req: _GenRequest, item) -> None:
        """Queue one stream item. While a decode step (or a speculative
        round) hands out its tokens, the consumers' ``stream_notify``
        calls wait for the step's end (:meth:`_notify_deferred`), so an
        event-loop consumer wakes once a step for all of its streams,
        not once a token."""
        if self._deferred is None:
            req._stream_push(item)
        else:
            req.stream_q.put(item)
            self._deferred.append(req)

    def _notify_deferred(self) -> None:
        """Notify the consumers of the items queued since ``_deferred``
        was set: each hook once an item, as :meth:`_push` would have,
        but hooks that share a ``many`` attribute (one event loop's
        streams) once in all, through it."""
        reqs, self._deferred = self._deferred, None
        groups: Dict[Callable, list] = {}
        for req in reqs or ():
            many = getattr(req.stream_notify, "many", None)
            if many is None:
                req._notify()
            else:
                groups.setdefault(many, []).append(req.stream_notify)
        for many, hooks in groups.items():
            try:
                many(hooks)
            except Exception:  # noqa: BLE001 — the consumer's fault
                pass

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
            self._push(req, ("token", token))
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
        self._trace_terminal(req, reason=reason)
        if req.stream_q is not None:
            self._push(req, ("done", reason))
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
                self._expire(req)
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

    def _expire(self, req: _GenRequest):
        """Shed a request whose deadline budget went while it was queued,
        at dequeue: no device work is spent on it."""
        self.metrics.inc("shed_deadline")
        if req.trace is not None:
            req.trace.span(
                "admission", verdict="expired",
                prefill_ms_per_tok=round(self._prefill_ms_per_tok, 4),
                decode_ewma_ms=round(self._decode_ewma_ms, 3)).end()
        self._fail(req, DeadlineExceededError(
            "deadline budget exhausted in the generation queue"))

    def _prefill(self, req: _GenRequest):
        """Prefill a request into a fresh slot: its prompt, or after a
        recovery :func:`_recovery_seq`. A prefill call that raises fails
        this request with its error and raises
        :class:`CorruptedStateFault`: the call may have written any
        slot's cache, so the others recover."""
        # before the slot claim: a TransientFault leaves nothing to undo
        self._hit("prefill")
        if req.trace is not None:
            req.qspan.end()  # the queue wait ends at the slot claim
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
                first, ok, cold = self._prefill_call(tokens, L, slot, req)
        except Exception as e:
            self._release_slot(slot)
            self._fail(req, e)
            raise CorruptedStateFault(
                f"prefill device call failed: {e!r}") from e
        t1 = time.perf_counter()
        self._note_prefill_cost((t1 - t0) * 1e3, bucket, cold)
        if req.trace is not None:
            req.trace.span("prefill", t_start=t0, t_end=t1, bucket=bucket,
                           chunks=1, resumed=bool(req.tokens))
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
        self._start_decode(slot, req, first, seq)

    def _start_decode(self, slot: int, req: _GenRequest, first: int,
                      seq: np.ndarray):
        """Make a request whose ``seq`` was prefilled (its K/V written)
        a decode lane, priming its draft when speculating. A fresh
        request's first token is prefill's, and is delivered. A
        recovered request's stream stands: it resumes from its last
        emitted token at the PRNG fold a fault-free run would use next,
        and prefill's token is discarded."""
        st = self._slots
        resumed = bool(req.tokens)
        st.token[slot] = req.tokens[-1] if resumed else first
        st.pos[slot] = len(seq)  # where the next token's K/V goes
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
        if req.trace is not None and req.pipe_d0 is None \
                and self.decode_pipeline:
            # the synchronous loop (speculation forces it) has no
            # pipeline to report, as in the JAX engine
            req.pipe_d0 = self._step_span_s
            req.pipe_w0 = self._sync_wait_s
        self.metrics.active_slots = st.active_count
        if self.cache_backend == "paged":
            self._update_block_gauges()
        if self.speculation_k:
            # the draft always prefills the whole committed prefix: it
            # shares nothing, whatever the target's prefix cache skipped
            self._spec_prime(slot, seq)
        if resumed:
            return
        self.metrics.tokens.record(1)
        self._emit(req, first, time.perf_counter())
        self._check_done(slot, req, first)

    def _note_prefill_cost(self, dt_ms: float, bucket: int,
                           cold: bool = False):
        """Record one prefill (or chunk) call and feed the per-token
        EWMA, except from a bucket's first call and a ``cold`` one (it
        captured its graph), which pay one-time costs."""
        self.metrics.prefill_ms.record(dt_ms)
        if bucket in self._hot_buckets and not cold:
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
                      ) -> Tuple[int, List[int], Optional[int],
                                 Optional[str]]:
        """Longest cached prefix of the prompt -> ``(match_len,
        shared_blocks, cow_src, source)``. The session store is consulted
        first (token-granular, ``source`` "session"), then the prefix
        index (block-granular, "index").
        ``shared_blocks`` are matched full blocks the request reads
        through its table; ``cow_src`` holds the matched tail when the
        match ends mid-block, and admission copies it into a private
        block because the request writes there from ``match_len`` on.
        ``match_len`` is capped at len(prompt) - 1: the last prompt
        position is computed to sample the first token. A recovery's
        re-admission (tokens already emitted) never matches: its block
        budget and its token stream are settled."""
        if not self.enable_prefix_sharing or req.tokens:
            return 0, [], None, None
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
                    return m, list(sess.blocks[:m // bs]), cow, "session"
            self.metrics.inc("session_misses")
        matched = self._prefix_index.match(chain_hashes(prompt, bs))
        if not matched:
            return 0, [], None, None
        m = len(matched) * bs
        cow = None
        if m >= L:
            # a block-aligned prompt matched whole: keep its last block
            # as a COW source so only the final position re-prefills
            m = L - 1
            matched, cow = matched[:m // bs], matched[m // bs]
        self.metrics.inc("prefix_hits")
        self.metrics.inc("prefix_tokens_matched", m)
        return m, list(matched), cow, "index"

    def _evict_one_pin(self, protect=frozenset()) -> bool:
        """Release ONE cache pin under block pressure: the LRU prefix
        index entry first (but those whose digest is in ``protect``),
        then the LRU session. False when nothing is evictable. With the
        KV tier on, eviction DEMOTES: the pin's block run is copied to
        the host before its blocks are freed (a torn demotion degrades
        to the discard; the free runs either way)."""
        ent = self._prefix_index.evict_lru_entry(protect)
        if ent is not None:
            digest, b = ent
            self._demote_prefix(digest, b)
            self._allocator.free([b])
            self.metrics.inc("prefix_evictions")
            return True
        sess = self._sessions.evict_lru()
        if sess is not None:
            self._demote_session(sess)
            self._allocator.free(sess.blocks)
            self.metrics.inc("session_evictions")
            return True
        return False

    def _alloc_with_eviction(self, n: int, protect=frozenset()
                             ) -> Optional[List[int]]:
        """All-or-nothing alloc that reclaims cache pins under pressure
        (in-flight requests outrank caching), never the prefix-index
        entries whose digest is in ``protect``. None when even an
        evicted pool cannot cover ``n``; then no pin is evicted. (The
        JAX engine evicts them all first: a request held for blocks then
        evicts, and with the KV tier demotes, the very session it
        matched, and restores it again at every retry.)"""
        blocks = self._allocator.alloc(n)
        if blocks is not None:
            return blocks
        if self._allocator.free_count + self._reclaimable(protect) < n:
            return None
        while True:
            if not self._evict_one_pin(protect):
                return None
            blocks = self._allocator.alloc(n)
            if blocks is not None:
                return blocks

    def _reclaimable(self, protect=frozenset()) -> int:
        """Blocks that evicting every pin but the ``protect``ed prefix
        entries would free: those whose every owner is such a pin."""
        pins = collections.Counter(b for h, b in self._prefix_index.entries()
                                   if h not in protect)
        for blocks, _ in self._sessions.iter_pins():
            pins.update(blocks)
        ref = self._allocator.ref
        return sum(1 for b, c in pins.items() if ref(b) == c)

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
                self._expire(req)
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
            if self._offload is not None:
                # restore before matching: a demoted session (or demoted
                # prefix blocks) scatters back into the pool, so
                # _match_prefix sees a normal hit. A torn restore already
                # fell back to re-prefill inside; a real scatter failure
                # escapes for recompute-recovery, the request re-admitted
                # in order
                try:
                    restored = self._offload_restore(req)
                    if restored is None:
                        # the run waits for blocks in-flight work holds
                        self._hold(req)
                        return
                    self._restore_prefix_blocks(req)
                except CorruptedStateFault:
                    self._requeue.appendleft(req)
                    raise
                self._update_block_gauges()
            match_len, shared, cow_src, source = self._match_prefix(req)
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
                self._hold(req)
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
            if req.trace is not None and match_len:
                full = sum(b for _, b, _ in self._chunk_plan(L))
                part = sum(b for _, b, _ in plan)
                req.trace.span(
                    "prefix_match", source=source, matched_tokens=match_len,
                    matched_blocks=len(shared), cow=cow_src is not None,
                    saved_est_ms=round(
                        (full - part) * self._prefill_ms_per_tok, 3)).end()
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
            if req.trace is not None:
                req.qspan.end()  # the queue wait ends at the block claim
            self._prefilling.append(_ChunkState(
                req, slot, table, tbl_bucket, plan, seq, start=match_len))
            self.metrics.active_slots = self._slots.active_count
            self._update_block_gauges()

    def _hold(self, req: _GenRequest):
        """Park an admission that waits for blocks at the head of the
        line (FIFO) until retirements free them."""
        if self._held is None:
            self._held = req
        else:
            # another request already waits for blocks (this one came
            # from the re-admission deque): it goes back there, ahead of
            # the held one's successors
            self._requeue.appendleft(req)

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
                first, ok, cold = self._chunk_call(
                    tokens, p0, clen, st.table.padded(st.tbl_bucket), req)
        except Exception as e:
            self._prefilling.popleft()
            self._release_slot(st.slot)
            self._fail(req, e)
            raise CorruptedStateFault(
                f"prefill chunk device call failed: {e!r}") from e
        t1 = time.perf_counter()
        self._note_prefill_cost((t1 - t0) * 1e3, bucket, cold)
        if req.trace is not None:
            req.trace.span("prefill", t_start=t0, t_end=t1, bucket=bucket,
                           chunk=st.idx, chunks=len(st.plan))
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
        self._start_decode(st.slot, req, first, st.seq)

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
            # the same session's superseded pin is not an eviction; an
            # LRU-displaced one demotes to the host tier
            if sess.session_id != req.session_id:
                self._demote_session(sess)
                evictions += 1
            self._allocator.free(sess.blocks)
        if evictions:
            self.metrics.inc("session_evictions", evictions)
        if self._offload is not None:
            # the fresh device pin supersedes any demoted copy: a stale
            # host run must never be restored over it
            self._offload.pop(req.session_id)
            if self._offload_prefetcher is not None:
                self._offload_prefetcher.discard(req.session_id)
        self._slots.free(slot)
        self._slot_blocks[slot] = None
        self._tables[slot] = NULL_BLOCK
        self._update_block_gauges()
        self.metrics.active_slots = self._slots.active_count

    # -- speculative decoding (serving/speculative.py) ------------------
    def _reset_draft_cache(self, disable_lanes: bool = False):
        """Zero the draft cache IN PLACE (the propose graph holds its
        addresses): after recompute-recovery and poison (lanes re-prime
        at their decode entry), and when a draft call failed mid-flight,
        which with ``disable_lanes`` drops every lane to plain decode
        until it is primed again, without touching the target's state:
        a draft failure never costs target work."""
        self._draft_cache.reset()
        if disable_lanes:
            self._slots.spec_ok[:] = False

    def _spec_prime(self, slot: int, seq: np.ndarray):
        """Prefill the draft over a lane's committed prefix (the prime
        graph of its bucket, one sync), marking the lane eligible when
        the draft's logits are finite. Any draft failure here, a capture
        at a cold bucket's second call included, costs speculation
        only."""
        L = len(seq)
        bucket = next(b for b in self._prime_buckets if b >= L)
        try:
            out, _ = self._device_call(("prime", bucket), self._prime_in,
                                       self._prime_out, tok=seq, length=L,
                                       slot=slot)
        except Exception:  # noqa: BLE001 — the target is untouched
            self._reset_draft_cache(disable_lanes=True)
            self.metrics.inc("spec_draft_fallbacks")
            return
        ok = bool(out[0])
        self._slots.spec_ok[slot] = ok
        if not ok:
            self.metrics.inc("spec_draft_fallbacks")

    def _spec_cow_guard(self, slot: int, p0: int) -> bool:
        """Copy-on-write isolation before any speculative write: a
        verify span writes positions ``[p0, p0 + vbucket)`` (and the
        passenger decode write one of them), and none may land in a
        block another table still reads. Today's sharing shares only
        prompt-prefix blocks, below every decode cursor, but the guard
        is cheap (refcount reads) and keeps speculation safe against any
        sharing pattern. False when no private block could be had (the
        pool is exhausted): the lane skips speculation this round."""
        table = self._slot_blocks[slot]
        bs = self.block_size
        last = min((p0 + self._vbucket) // bs, len(table.blocks) - 1)
        for i in range(p0 // bs, last + 1):
            b = table.blocks[i]
            if self._allocator.ref(b) <= 1:
                continue
            fresh = self._alloc_with_eviction(1)
            if fresh is None:
                return False
            try:
                self._cow(b, fresh[0])
            except Exception as e:  # noqa: BLE001 — the pool may be half
                # written: recovery rebuilds it
                raise CorruptedStateFault(
                    f"speculative COW device copy failed: {e!r}") from e
            self._allocator.free([b])
            table.blocks[i] = fresh[0]
            self._tables[slot] = table.padded(self._blocks_per_seq)
            self.metrics.inc("cow_copies")
        return True

    def _propose_call(self) -> Tuple[np.ndarray, np.ndarray]:
        """One draft call over every lane: [token, pos] from a pinned
        buffer into the static input buffer, the propose graph's replay
        (eager on the CPU, and in an engine never warmed until its first
        call has run), and the [S, k] proposals and [S] ok flags back to
        the host (a sync)."""
        st = self._slots
        h_in = self._host((2, self.num_slots), torch.int64)
        h_in.numpy()[:] = (st.token, st.pos)
        self._prop_in.copy_(h_in, non_blocking=True)
        if self._draft_graph is not None:
            self._draft_graph.replay()
            add_launches(self._draft_graph_launches)
        else:
            self._run_propose()
        self._draft_hot = True
        out = self._prop_out.cpu().numpy()
        k = self.speculation_k
        return out[:, :k], out[:, k].astype(bool)

    def _verify_call(self, slot: int, tokens: np.ndarray, p0: int,
                     req: _GenRequest, table: Optional[np.ndarray] = None
                     ) -> List[int]:
        """One verify span of ``slot``'s lane from ``p0`` (its table on
        the paged backend): the verify graph of its table bucket (one on
        slots), one sync. Returns [tgt..., n_accepted, ok]."""
        vb = self._vbucket
        key = ("verify",) if table is None else ("verify", len(table))
        where = dict(slot=slot) if table is None else dict(table=table)
        step0 = int(self._slots.step[slot])
        out, _ = self._device_call(
            key, self._verify_in, self._verify_out, tok=tokens, p0=p0,
            vlen=self.speculation_k + 1, top_k=req.top_k,
            temp=req.temperature,
            u=verify_uniforms(req.seed, step0, req.temperature, vb).numpy(),
            **where)
        return out.tolist()

    def _spec_step(self) -> frozenset:
        """One speculative round: ONE draft call proposes k tokens for
        every lane, then each eligible lane's proposals are verified in
        one target span and its accepted run committed. Returns the
        slots this round advanced (the plain decode step skips them).
        Eligibility: a primed lane with at least k + 1 tokens left, so
        every span has full width and never writes past the lane's
        blocks or slot. Acceptance, rollback and the identity contract
        live in ``serving/speculative.py``."""
        st = self._slots
        k = self.speculation_k
        lanes = [s for s in self._ready_slots() if st.spec_ok[s]
                 and st.requests[s].max_tokens - len(st.requests[s].tokens)
                 >= k + 1]
        if not lanes:
            return frozenset()
        if self._cuda_graph and self._draft_graph is None \
                and self._draft_hot:
            # outside the draft's except: a failed capture raises, as
            # the decode step's does, and nothing runs eagerly instead
            self._capture_draft_graph()
        t0 = time.perf_counter()
        try:
            # the seam sits inside the except: any draft fault, injected
            # or real, transient or corrupting, costs speculation only
            self._hit("draft")
            with self._profiler.record("generation.spec_draft"):
                props, dok = self._propose_call()
        except Exception:  # noqa: BLE001 — the target state is intact
            self._reset_draft_cache(disable_lanes=True)
            self.metrics.inc("spec_draft_fallbacks", len(lanes))
            return frozenset()
        t1 = time.perf_counter()
        self.metrics.spec_draft_ms.record((t1 - t0) * 1e3)
        vb = self._vbucket
        paged = self.cache_backend == "paged"
        serviced = set()
        emitted = 0
        itl: List[float] = []
        for s in lanes:
            req = st.requests[s]
            if not dok[s]:
                # a draft NaN costs this lane's speculation only: it
                # plain-decodes from here on (re-primed on recovery)
                st.spec_ok[s] = False
                self.metrics.inc("spec_draft_fallbacks")
                continue
            p0 = int(st.pos[s])
            tokens = np.zeros(vb, np.int64)
            tokens[0] = st.token[s]
            tokens[1:k + 1] = props[s]
            padded = None
            if paged:
                if not self._spec_cow_guard(s, p0):
                    continue
                table = self._slot_blocks[s]
                # the padded table covers the span's padded tail (the
                # chunk path raises on an index past its table), capped
                # as JAX caps it: every bucket stays in the warmed set
                tv = pow2_bucket(max(blocks_for(p0 + vb, self.block_size),
                                     len(table.blocks)), cap=self._tbl_top)
                padded = table.padded(tv)
            self._hit("verify")
            v0 = time.perf_counter()
            try:
                with self._profiler.record("generation.spec_verify"):
                    out = self._verify_call(s, tokens, p0, req, padded)
            except Exception as e:  # noqa: BLE001 — the call may have
                # written any of the target's cache: fail this request,
                # recover the others
                self._release_slot(s)
                self._fail(req, e)
                raise CorruptedStateFault(
                    f"speculative verify device call failed: {e!r}") from e
            v1 = time.perf_counter()
            self.metrics.spec_verify_ms.record((v1 - v0) * 1e3)
            n_acc, vok = out[vb], out[vb + 1]
            if not vok:
                # the target's logits went non-finite on this lane's own
                # tokens: quarantined alone, as a decode step rules
                self.metrics.inc("quarantined")
                exc = PoisonRequestError(
                    "request produced non-finite logits during "
                    f"speculative verify at step {int(st.step[s])}; "
                    "quarantined")
                self._release_slot(s)
                self._fail(req, exc)
                continue
            n_emit = n_acc + 1
            self.metrics.inc("spec_verify_batches")
            self.metrics.inc("spec_draft_tokens_proposed", k)
            self.metrics.inc("spec_draft_tokens_accepted", n_acc)
            if n_acc < k:
                # the rejected tail is rolled back by not committing it
                self.metrics.inc("spec_rollbacks")
            if req.trace is not None:
                req.spec_rounds += 1
                req.spec_proposed += k
                req.spec_accepted += n_acc
                req.spec_emitted += n_emit
                if req.spec_dt0 is None:
                    req.spec_dt0, req.spec_vt0 = t0, v0
                req.spec_dt1, req.spec_vt1 = t1, v1
            serviced.add(s)
            self._deferred = []     # one wakeup for the lane's tokens
            for j in range(n_emit):
                self._emit(req, out[j], v1, itl_out=itl)
                emitted += 1
                if self._check_done(s, req, out[j]):
                    break
            else:
                # commit left the lane's current token on the host
                st.commit(s, out[n_acc], n_emit)
                self._tok_on_dev[s] = False
            self._notify_deferred()
        if emitted:
            self.metrics.tokens.record(emitted)
        if itl:
            self.metrics.itl_ms.record_many(itl)
        if paged:
            self._update_block_gauges()
        return frozenset(serviced)

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
        # in place: the CUDA graphs keep their addresses
        self._cache.reset()
        if self.speculation_k:
            self._reset_draft_cache()

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
        if self.speculation_k:
            # the draft replays nothing: each re-admitted lane re-primes
            # at its decode entry (spec_ok goes with the slots)
            self._reset_draft_cache()
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
                if req.trace is not None:
                    req.trace.span("recovery", why=why,
                                   tokens_kept=len(req.tokens)).end()
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
                    # a speculative round first; the lanes it advanced
                    # sit out the plain step that serves the others
                    spun = (self._spec_step() if self.speculation_k
                            else frozenset())
                    # dispatch step t+1 first, then collect step t: the
                    # admit and prefill work above and the emit/retire
                    # work in the collect overlap the step just launched
                    launched = self._dispatch_decode(skip=spun)
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
                finally:
                    # a step cut short by a fault still wakes the
                    # consumers of what it queued
                    self._notify_deferred()
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

    def offload_sessions(self) -> int:
        """Demote EVERY session pin to the host tier (freeing its device
        blocks); returns how many demoted cleanly (0 without the tier).
        For maintenance before a restart, or to force the cold path."""
        if self.cache_backend != "paged" or self._offload is None:
            return 0

        def job() -> int:
            sessions = self._sessions.clear()
            demoted = 0
            for sess in sessions:
                demoted += self._demote_session(sess)
                self._allocator.free(sess.blocks)
            if sessions:
                self.metrics.inc("session_evictions", len(sessions))
            self._update_block_gauges()
            return demoted
        return self._on_scheduler(job)

    def clear_offload(self) -> int:
        """Drop every demoted run from the host and disk tiers; returns
        how many runs went. Their sessions re-prefill on their next
        turn."""
        off = self._offload
        if off is None:
            return 0

        def job() -> int:
            n = len(off.keys())
            off.clear()
            self._restore_parked.clear()
            self._update_block_gauges()
            return n
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
        flight. Then the prefetch thread stops and the host tier closes
        (its disk ring unlinks its temp file)."""
        self._running = False
        self._wake.set()
        self._thread.join(timeout=timeout_s)
        if self._offload_prefetcher is not None:
            self._offload_prefetcher.stop()
        if self._offload is not None:
            self._offload.close()
