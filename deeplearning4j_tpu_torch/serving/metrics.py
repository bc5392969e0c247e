"""Serving counters and their Prometheus text (counterpart of
``deeplearning4j_tpu/serving/metrics.py``, lifted): ``ServingMetrics``
for the predict path (the micro-batcher's queue, shed and deadline
counters, the engine's graph cache), ``GenerationMetrics`` with the
counters the slot and paged backends, the int8 KV cache, the fault
ladder, speculative decoding and the host KV tier move, and the text
exposition: :func:`prometheus_text` renders a ``stats()``-shaped
snapshot (``GET /stats`` of the HTTP server) into the same families as
the JAX package's, served at ``GET /metrics``."""
from __future__ import annotations

import re
import threading
from typing import Dict, List

from ..profiler import (RESERVOIR_SNAPSHOT_KEYS, CountHistogram, OpProfiler,
                        RateMeter, Reservoir)


class ServingMetrics:
    """Always-on counters for one served model (the reference's
    PerformanceListener role, serving-side). Scalar counters are
    mutated from many HTTP handler threads — use :meth:`inc`, not
    ``+=`` (attribute += is load/add/store and loses updates under
    preemption)."""

    def __init__(self, latency_window: int = 8192):
        self._lock = threading.Lock()
        self.requests = 0          # accepted into the queue/engine
        self.responses = 0         # successful results returned
        self.client_errors = 0     # 4xx-class failures
        self.server_errors = 0     # 5xx-class failures
        self.shed = 0              # rejected, queue full (503)
        self.shed_batch = 0        # batch-priority work shed first (503)
        self.shed_deadline = 0     # deadline budget blown before the
        #                            device call: rejected at dequeue-
        #                            admission, zero device work spent
        self.timeouts = 0          # request deadline exceeded (504)
        # fault-tolerance counters (serving/faults.py)
        self.retries = 0           # transient step failures retried
        self.recoveries = 0        # state rebuilds (n/a for batcher)
        self.quarantined = 0       # poison requests failed alone
        self.drains = 0            # graceful drains initiated
        self.batches = 0           # device calls issued
        self.batch_hist = CountHistogram()   # rows per device call
        self.bucket_hist = CountHistogram()  # padded bucket per call
        self.latency_ms = Reservoir(latency_window)    # request e2e
        self.device_ms = Reservoir(latency_window)     # device call
        self.queue_depth = 0       # gauge, updated by the batcher
        self.queue_max = 0
        self.inflight = 0          # gauge: rows in the device call NOW
        # the engine's (bucket, signature) cache: a CUDA graph captured
        # per entry on the card, the eager forward on the CPU
        self.compiles = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.warmed_buckets: List[int] = []

    def inc(self, field: str, n: int = 1):
        """Thread-safe counter increment."""
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def mean_batch(self) -> float:
        """Mean number of real rows per device call — the coalescing
        factor (1.0 means the batcher never merged anything)."""
        return self.batch_hist.mean()

    def snapshot(self) -> Dict:
        return {
            "requests": self.requests,
            "responses": self.responses,
            "client_errors": self.client_errors,
            "server_errors": self.server_errors,
            "shed": self.shed,
            "shed_batch": self.shed_batch,
            "shed_deadline": self.shed_deadline,
            "timeouts": self.timeouts,
            "faults": {
                "retries": self.retries,
                "recoveries": self.recoveries,
                "quarantined": self.quarantined,
                "drains": self.drains,
            },
            "queue_depth": self.queue_depth,
            "queue_max": self.queue_max,
            "inflight": self.inflight,
            "batches": self.batches,
            "mean_batch": round(self.mean_batch(), 3),
            "batch_hist": self.batch_hist.snapshot(),
            "bucket_hist": self.bucket_hist.snapshot(),
            "latency_ms": {k: round(v, 3) for k, v in
                           self.latency_ms.snapshot().items()},
            "device_ms": {k: round(v, 3) for k, v in
                          self.device_ms.snapshot().items()},
            "compile_cache": {
                "compiles": self.compiles,
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "evictions": self.cache_evictions,
                "warmed_buckets": list(self.warmed_buckets),
            },
        }


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
        self.client_errors = 0     # 4xx-class failures (counted by the
        #                            HTTP server; the engine raises them)
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
            "client_errors": self.client_errors,
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


def profiler_sections() -> Dict:
    """The profiler's own `serving.*` section timings (populated when
    ProfilingMode is OPERATIONS/ALL), merged into `GET /stats`."""
    return {name: stats for name, stats in
            OpProfiler.get_instance().timings().items()
            if name.startswith("serving.")}


# -- Prometheus text exposition ----------------------------------------
# The text is generated from the SAME snapshot dicts `stats()` returns
# (and the server's `GET /stats` serves beside `GET /metrics`), so the
# two views cannot drift: one source of truth, two encodings.
# Output follows the text exposition format version 0.0.4 (`# TYPE`
# lines, label escaping, one family per metric name).

#: monotonically increasing snapshot fields -> emitted as counters with
#: the conventional ``_total`` suffix; every other numeric leaf is a
#: gauge. Keyed by the LEAF name, so ``faults.retries`` matches
#: ``retries`` here.
_PROM_COUNTERS = frozenset({
    "requests", "responses", "client_errors", "server_errors",
    "shed", "shed_batch", "shed_deadline", "timeouts",
    "retries", "recoveries", "quarantined", "drains",
    "batches", "prefills", "decode_steps", "tokens_generated",
    "prefill_chunks", "chunked_prefills",
    "prefix_hits", "session_hits", "session_misses",
    "prefix_tokens_matched", "prefill_tokens", "cow_copies",
    "prefix_evictions", "session_evictions",
    # speculative decoding (the `spec` snapshot block; leaf names —
    # `spec_verify_batches` also matches the `batches` rule, the rest
    # are matched here)
    "draft_tokens_proposed", "draft_tokens_accepted", "verify_batches",
    "rollbacks", "draft_fallbacks",
    # hierarchical KV tier (the `paged.offload` snapshot block)
    "demotions", "restores", "prefetch_hits", "demote_failures",
    "restore_failures",
    "compiles", "hits", "misses", "evictions",
    "client_disconnects",
    # fleet-side counters
    "routed", "hedges", "hedges_won", "hedge_budget_denied",
    "requests_lost", "ejections", "readmissions", "restarts",
    "streams", "sheds", "cooldowns", "breaker_trips",
    "breaker_probes", "breaker_recoveries", "fleet_shed",
    "session_affinity_hits",
    # training-side counters (supervisor / async writer / per-worker
    # fleet telemetry / event-timeline rollups / stats router)
    "anomalies_skipped", "async_checkpoints", "sync_checkpoints",
    "sharded_checkpoints", "preemptions", "preempts_broadcast",
    "preempts_received", "writes", "steps", "preempts",
    "anomaly_skips", "dropped",
    "preempt_broadcast", "preempt_received", "anomaly_skip",
    "rollback", "checkpoint_commit", "re_mesh", "resume",
})

_RESERVOIR_KEYS = frozenset(RESERVOIR_SNAPSHOT_KEYS)


def _prom_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    name = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _prom_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _PromWriter:
    """Accumulates samples grouped per metric family (the exposition
    format requires all lines of one name to be contiguous, with the
    `# TYPE` line first)."""

    def __init__(self):
        self._families: "Dict[str, Dict]" = {}

    def sample(self, name: str, mtype: str, labels: Dict, value):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {"type": mtype, "lines": []}
        lab = ",".join(f'{k}="{_prom_escape(v)}"'
                       for k, v in labels.items() if v is not None)
        fam["lines"].append(
            f"{name}{{{lab}}} {_prom_value(value)}" if lab
            else f"{name} {_prom_value(value)}")

    def render(self) -> str:
        out = []
        for name, fam in self._families.items():
            out.append(f"# TYPE {name} {fam['type']}")
            out.extend(fam["lines"])
        return "\n".join(out) + "\n" if out else "\n"


def _walk(w: _PromWriter, base: str, labels: Dict, obj) -> None:
    """Recursively flatten a stats snapshot into exposition samples.
    Reservoir-shaped dicts become summaries (quantile-labelled, plus
    `_count`); integer-keyed dicts (CountHistograms) become one
    labelled series; strings are skipped (identity lives in labels)."""
    if isinstance(obj, bool) or isinstance(obj, (int, float)):
        if any(base.endswith("_" + c) or base == c
               for c in _PROM_COUNTERS):
            w.sample(base + "_total", "counter", labels, obj)
        else:
            w.sample(base, "gauge", labels, obj)
        return
    if isinstance(obj, dict):
        if obj and set(obj) == _RESERVOIR_KEYS:
            for q, key in (("0.5", "p50"), ("0.9", "p90"),
                           ("0.99", "p99")):
                w.sample(base, "summary",
                         {**labels, "quantile": q}, obj[key])
            w.sample(base + "_count", "summary", labels, obj["count"])
            w.sample(base + "_mean", "gauge", labels, obj["mean"])
            w.sample(base + "_max", "gauge", labels, obj["max"])
            return
        if obj and all(_is_int_key(k) for k in obj) and \
                all(isinstance(v, (int, float)) for v in obj.values()):
            # CountHistogram shape: int keys, numeric values -> one
            # bucket-labelled series. Int-keyed dicts of DICTS (e.g.
            # per-worker fleet telemetry) fall through to nested paths
            for k, v in obj.items():
                w.sample(base, "gauge", {**labels, "bucket": k}, v)
            return
        for k, v in obj.items():
            _walk(w, _prom_name(base, str(k)), labels, v)
        return
    if isinstance(obj, (list, tuple)):
        w.sample(base + "_count", "gauge", labels, len(obj))
        return
    # strings / None: identity belongs in labels, not sample values


def _is_int_key(k) -> bool:
    try:
        int(k)
        return True
    except (TypeError, ValueError):
        return False


def prometheus_text(stats: Dict, prefix: str = "dl4j") -> str:
    """Render a `/stats`-shaped snapshot (replica server or fleet
    router) as Prometheus text exposition. Replica server snapshots
    (``{"summary", "models", "profiler"}``) emit per-model families
    labelled ``{model=...}``; fleet snapshots (``{"fleet": ...}``)
    emit fleet counters plus per-replica gauges labelled
    ``{replica=...}``."""
    w = _PromWriter()
    if "models" in stats:
        summary = dict(stats.get("summary") or {})
        summary.pop("models", None)      # covered by the models block
        _walk(w, _prom_name(prefix, "server"), {}, summary)
        for mname, snap in (stats.get("models") or {}).items():
            _walk(w, _prom_name(prefix, "model"), {"model": mname}, snap)
        for section, timing in (stats.get("profiler") or {}).items():
            _walk(w, _prom_name(prefix, "profiler"),
                  {"section": section}, timing)
    elif "fleet" in stats:
        fl = dict(stats["fleet"])
        replicas = fl.pop("replicas", [])
        _walk(w, _prom_name(prefix, "fleet"), {}, fl)
        for rep in replicas:
            rid = rep.get("id") if isinstance(rep, dict) else None
            _walk(w, _prom_name(prefix, "replica"),
                  {"replica": rid}, rep)
    else:
        _walk(w, prefix, {}, stats)
    return w.render()
