"""Generation-engine counters (counterpart of
``deeplearning4j_tpu/serving/metrics.py::GenerationMetrics``, with the
counters the slot and paged backends, the int8 KV cache, the fault
ladder, speculative decoding and the host KV tier move; the Prometheus
exposition comes with the serving shell, ROADMAP.md queue A, item 9)."""
from __future__ import annotations

import threading
from typing import Dict, List

from ..profiler import CountHistogram, RateMeter, Reservoir


class GenerationMetrics:
    """Always-on counters for one generation engine. Scalar counters
    are written from request threads and the scheduler thread: use
    :meth:`inc`, never ``+=`` (a load/add/store loses updates under
    preemption)."""

    def __init__(self, latency_window: int = 8192,
                 rate_window_s: float = 30.0):
        self._lock = threading.Lock()
        self.requests = 0          # accepted into the queue
        self.responses = 0         # finished generations returned
        self.server_errors = 0     # 5xx-class failures
        self.shed = 0              # rejected, queue full (503)
        self.shed_batch = 0        # batch-priority work shed first (503)
        self.shed_deadline = 0     # deadline budget blown before any
        #                            device work: rejected at admission
        self.timeouts = 0          # deadline exceeded (504)
        # the fault ladder (serving/generation.py): transient step
        # failures retried with backoff, recompute-recoveries (every
        # in-flight request re-admitted and re-prefilled), poison
        # requests failed alone (500), graceful drains
        self.retries = 0
        self.recoveries = 0
        self.quarantined = 0
        self.drains = 0
        self.prefills = 0          # prefill device calls
        self.decode_steps = 0      # decode device calls (all slots)
        self.tokens = RateMeter(rate_window_s)   # generated tokens
        self.occupancy_hist = CountHistogram()   # active slots per step
        self.prompt_bucket_hist = CountHistogram()  # padded prefill len
        self.ttft_ms = Reservoir(latency_window)    # submit -> 1st token
        self.itl_ms = Reservoir(latency_window)     # inter-token gap
        self.prefill_ms = Reservoir(latency_window)
        self.decode_step_ms = Reservoir(latency_window)
        # pipelined decode: how long the scheduler blocked at step t's
        # sync after dispatching step t+1 (near zero when host work
        # overlaps the device, near decode_step_ms when the device is
        # the bottleneck)
        self.decode_sync_wait_ms = Reservoir(latency_window)
        # speculative decoding (serving/speculative.py; both backends;
        # all zero with speculation_k=0)
        self.speculation_k = 0            # config knob (0 = off)
        self.spec_draft_tokens_proposed = 0  # k per verify round
        self.spec_draft_tokens_accepted = 0  # target-matched prefix
        self.spec_verify_batches = 0      # verify device calls
        self.spec_rollbacks = 0           # rounds with a rejected tail
        self.spec_draft_fallbacks = 0     # draft failures -> plain
        #                                   decode (lane never failed)
        self.spec_draft_ms = Reservoir(latency_window)   # propose call
        self.spec_verify_ms = Reservoir(latency_window)  # one lane's span
        self.compiles = 0          # CUDA graph captures (graph_plan)
        self.queue_depth = 0       # gauge, updated by the scheduler
        self.queue_max = 0
        self.active_slots = 0      # gauge
        self.num_slots = 0
        self.cache_bytes = 0
        self.kv_dtype = "f32"
        self.kv_bits = 32
        self.kv_bytes_per_token = 0    # K+V bytes per position, all
        #                                layers, int8 scales included
        self.quant_blocks_quantized = 0  # gauge: allocated int8 blocks
        self.quant_scale_bytes = 0       # f32 scale bytes (0 unless int8)
        # paged-cache gauges and counters (serving/paging.py; all zero
        # on the slot backend)
        self.cache_backend = "slots"
        self.block_size = 0
        self.blocks_total = 0          # allocatable blocks (excl. null)
        self.blocks_free = 0           # gauge
        self.blocks_peak_used = 0      # high-water mark
        self.prefill_chunks = 0        # chunk device calls
        self.chunked_prefills = 0      # prompts that spanned >1 chunk
        self.kv_tokens_live = 0        # written positions, live seqs
        self.kv_tokens_allocated = 0   # blocks_used * block_size
        # prefix sharing and sessions (paged backend only)
        self.prefix_sharing = False    # config flag
        self.prefix_hits = 0           # admissions that matched a prefix
        self.session_hits = 0          # ...matched via the session store
        self.session_misses = 0        # session_id sent, nothing pinned
        self.prefix_tokens_matched = 0  # prompt tokens served from cache
        self.prefill_tokens = 0        # prompt tokens actually computed
        self.cow_copies = 0            # copy-on-write block duplications
        self.prefix_evictions = 0      # index entries evicted
        self.session_evictions = 0     # sessions evicted (LRU/pressure)
        self.shared_blocks = 0         # gauge: blocks with refcount > 1
        self.prefix_blocks = 0         # gauge: blocks the index pins
        self.sessions_live = 0         # gauge
        # the hierarchical KV tier (serving/offload.py): demote-on-evict
        # to host RAM (and an optional disk ring), restore on resume.
        # All zero unless offload_host_bytes > 0
        self.offload_enabled = False   # config flag
        self.offload_demotions = 0     # device->host block-run copies
        self.offload_restores = 0      # host->device restores (each one
        #                                is a re-prefill avoided)
        self.offload_prefetch_hits = 0  # restores served from a staged
        #                                 prefetch (overlapped IO)
        self.offload_demote_failures = 0   # torn demotions -> discard
        self.offload_restore_failures = 0  # torn restores -> re-prefill
        self.offload_spills = 0        # gauge: RAM -> disk-ring spills
        self.offload_drops = 0         # gauge: runs lost off the bottom
        self.offload_host_runs = 0     # gauge: runs in host RAM
        self.offload_host_blocks = 0   # gauge: blocks in host RAM
        self.offload_host_bytes = 0    # gauge
        self.offload_disk_blocks = 0   # gauge: blocks in the disk ring
        self.offload_disk_bytes = 0    # gauge
        self.offload_restore_ms = Reservoir(latency_window)  # host->
        #                              device restore wall time
        self.offload_demote_ms = Reservoir(latency_window)
        self.warmed_buckets: List[int] = []

    def inc(self, field: str, n: int = 1):
        """Thread-safe counter increment."""
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> Dict:
        occ = self.occupancy_hist
        steps = occ.total()

        def res(r):
            return {k: round(v, 3) for k, v in r.snapshot().items()}

        paged = None
        if self.cache_backend == "paged":
            used = self.blocks_total - self.blocks_free
            alloc = self.kv_tokens_allocated
            paged = {
                "block_size": self.block_size,
                "blocks_total": self.blocks_total,
                "blocks_free": self.blocks_free,
                "blocks_used": used,
                "blocks_peak_used": self.blocks_peak_used,
                "utilization": round(used / self.blocks_total, 4)
                if self.blocks_total else 0.0,
                # internal fragmentation: the share of allocated token
                # capacity not (yet) holding live K/V
                "fragmentation": round(
                    1.0 - self.kv_tokens_live / alloc, 4)
                if alloc else 0.0,
                "kv_tokens_live": self.kv_tokens_live,
                "kv_tokens_allocated": alloc,
                "prefill_chunks": self.prefill_chunks,
                "chunked_prefills": self.chunked_prefills,
                "prefix_cache": {
                    "enabled": self.prefix_sharing,
                    "prefix_hits": self.prefix_hits,
                    "session_hits": self.session_hits,
                    "session_misses": self.session_misses,
                    "prefix_tokens_matched": self.prefix_tokens_matched,
                    "prefill_tokens": self.prefill_tokens,
                    "cow_copies": self.cow_copies,
                    "prefix_evictions": self.prefix_evictions,
                    "session_evictions": self.session_evictions,
                    "shared_blocks": self.shared_blocks,
                    "prefix_blocks": self.prefix_blocks,
                    "sessions_live": self.sessions_live,
                },
                "offload": {
                    "enabled": self.offload_enabled,
                    "demotions": self.offload_demotions,
                    "restores": self.offload_restores,
                    "prefetch_hits": self.offload_prefetch_hits,
                    "demote_failures": self.offload_demote_failures,
                    "restore_failures": self.offload_restore_failures,
                    "spills": self.offload_spills,
                    "drops": self.offload_drops,
                    "host_runs": self.offload_host_runs,
                    "host_blocks": self.offload_host_blocks,
                    "host_bytes": self.offload_host_bytes,
                    "disk_blocks": self.offload_disk_blocks,
                    "disk_bytes": self.offload_disk_bytes,
                    "restore_ms": res(self.offload_restore_ms),
                    "demote_ms": res(self.offload_demote_ms),
                },
            }
        return {
            "cache_backend": self.cache_backend,
            "paged": paged,
            "requests": self.requests,
            "responses": self.responses,
            "server_errors": self.server_errors,
            "shed": self.shed,
            "shed_batch": self.shed_batch,
            "shed_deadline": self.shed_deadline,
            "timeouts": self.timeouts,
            "faults": {"retries": self.retries,
                       "recoveries": self.recoveries,
                       "quarantined": self.quarantined,
                       "drains": self.drains},
            "queue_depth": self.queue_depth,
            "queue_max": self.queue_max,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "tokens_generated": self.tokens.total(),
            "tokens_per_sec": round(self.tokens.rate(), 3),
            "slots": {
                "num_slots": self.num_slots,
                "active": self.active_slots,
                "mean_occupancy": round(occ.mean(), 3),
                "utilization": round(occ.mean() / self.num_slots, 4)
                if (self.num_slots and steps) else 0.0,
                "occupancy_hist": occ.snapshot(),
            },
            "spec": {
                "enabled": self.speculation_k > 0,
                "speculation_k": self.speculation_k,
                "draft_tokens_proposed": self.spec_draft_tokens_proposed,
                "draft_tokens_accepted": self.spec_draft_tokens_accepted,
                "accept_rate": round(
                    self.spec_draft_tokens_accepted
                    / self.spec_draft_tokens_proposed, 4)
                if self.spec_draft_tokens_proposed else 0.0,
                "verify_batches": self.spec_verify_batches,
                "rollbacks": self.spec_rollbacks,
                "draft_fallbacks": self.spec_draft_fallbacks,
            },
            "spec_draft_ms": res(self.spec_draft_ms),
            "spec_verify_ms": res(self.spec_verify_ms),
            "prompt_bucket_hist": self.prompt_bucket_hist.snapshot(),
            "ttft_ms": res(self.ttft_ms),
            "itl_ms": res(self.itl_ms),
            "prefill_ms": res(self.prefill_ms),
            "decode_step_ms": res(self.decode_step_ms),
            "decode_sync_wait_ms": res(self.decode_sync_wait_ms),
            "kv_cache_bytes": self.cache_bytes,
            "kv_dtype": self.kv_dtype,
            "kv_bits": self.kv_bits,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "quant": {
                "blocks_quantized": self.quant_blocks_quantized,
                "scale_bytes": self.quant_scale_bytes,
            },
            "compile_cache": {
                "compiles": self.compiles,
                "warmed_buckets": list(self.warmed_buckets),
            },
        }
