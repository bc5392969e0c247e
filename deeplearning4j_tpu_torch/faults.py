"""Deterministic fault injection shared by serving and training
(counterpart of ``deeplearning4j_tpu/faults.py``, numpy only, carried
over line for line: the same seams, fault types, per-seam and
per-worker seeded decision streams, so one plan fires at the same calls
in both packages).

A seeded, scriptable :class:`FaultInjector` is fired at named SEAMS so
tests and the chip smoke run can make the runtimes fail in exactly the
ways real deployments do, deterministically.

Serving seams (fired by :class:`~.serving.generation.GenerationEngine`):

- ``device_step``   — immediately before a decode step is dispatched
  (the CUDA graph's replay or the eager step)
- ``prefill``       — immediately before a prefill / prefill chunk
- ``alloc``         — before claiming KV blocks at paged admission
- ``client_disconnect`` — per streamed token; a fire marks the request
  abandoned, as if the consumer hung up mid-stream
- ``latency``       — once per scheduler iteration; a fire sleeps
  ``latency_ms`` instead of raising (injects tail latency, not errors)
- ``draft``         — immediately before the speculative round's draft
  proposal call (``_spec_step``, serving/generation.py:2853), inside
  the call's except scope: any fire, corrupting included, costs
  speculation only (the lanes plain-decode until they re-prime)
- ``verify``        — immediately before each lane's verify call against
  the target cache (``_spec_step``, serving/generation.py:2890): a
  corrupting fire forces recompute-recovery, as ``device_step`` does
- ``offload_io``    — immediately before a KV-tier demotion (the
  device-to-host gather of ``_demote_session`` and ``_demote_prefix``,
  serving/generation.py:1220,1239) or restore (``_offload_restore`` and
  ``_restore_prefix_blocks``, :1314,1382) touches any engine state. A
  fire models torn tier IO: the engine drops the host copy and falls
  back to a plain discard (demotion) or a clean re-prefill (restore),
  so a failed tier copy never corrupts a lane. Combine with
  ``slow_ms`` to model a slow host or disk tier instead

Training seams (fired by
:class:`~.parallel.elastic.FaultTolerantTrainer`'s supervised loop and
its :class:`~.parallel.resilience.TrainingSupervisor`):

- ``data_batch``    — before each batch reaches the step (retried)
- ``train_step``    — immediately before each train step runs (retried;
  the step's inputs are untouched, so the retry replays it bit for bit)
- ``checkpoint_io`` — before each checkpoint write attempt (retried; a
  v3 write fires it once a shard, worker-scoped, and once before the
  manifest commit); combine with ``slow_ms`` to model a slow disk
- ``preempt``       — at each step boundary: a fire flushes a
  step-granular checkpoint and raises :class:`PreemptionFault`

Fault types injected at the raising seams:

- :class:`TransientFault` — raised before any device state changed, so
  the caller's state is intact and the step can simply be retried (the
  supervised loops do, with bounded exponential backoff).
- :class:`CorruptedStateFault` — models a device call dying after it
  wrote the KV cache: state is gone and the engine must rebuild
  (serving: recompute-recovery). Configure via
  ``corrupting={"device_step", ...}``.
- :class:`PreemptionFault` — the ``preempt`` seam's signal-shaped
  fault.

The injector is inert unless constructed and passed in
(``fault_injector=`` or ``set_fault_injector``); engines hold ``None``
by default and guard every seam with one attribute load. Each seam has
its own call counter and its own ``RandomState`` seeded from ``(seed,
seam)``, so the fire pattern at one seam never depends on how other
seams interleave.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Iterable, Optional

import numpy as np

#: the seams engines and trainers fire; anything else is a
#: configuration typo and fails loudly at construction rather than
#: silently never firing
SEAMS = ("device_step", "prefill", "alloc", "client_disconnect",
         "latency", "draft", "verify", "offload_io", "train_step",
         "data_batch", "checkpoint_io", "preempt")


class FaultError(RuntimeError):
    """Base class for injected / recoverable fault conditions. The
    serving layer maps these to HTTP 5xx via its default branch."""


class TransientFault(FaultError):
    """A retryable failure raised BEFORE any device call changed state:
    caller state is intact, so the supervised loop retries the step with
    bounded exponential backoff (surfaced only if retries exhaust AND
    recovery fails)."""


class CorruptedStateFault(FaultError):
    """A device call failed after it may have written the state it
    works on (the KV cache) — the in-flight state is unrecoverable from
    the device and the caller must rebuild (serving:
    recompute-recovery)."""


class PoisonRequestError(FaultError):
    """One request produced non-finite logits (NaN/Inf) — it is
    quarantined: failed alone with HTTP 500, its slot/blocks freed
    immediately, while the rest of the batch keeps decoding. The
    training analog is the in-graph finite-grads/loss guard that
    skips-and-counts anomalous batches."""


class PreemptionFault(FaultError):
    """The ``preempt`` seam fired — the platform is taking the machine
    (SIGTERM-shaped). The supervised training loop flushes a
    step-granular checkpoint and re-raises this so the caller can
    restart and ``FaultTolerantTrainer.resume`` bit-exactly."""


class FaultInjector:
    """Seeded, scriptable fault source consulted at named seams (see
    module docstring).

    ``rates``: ``{seam: probability}`` — fire ~that fraction of calls,
    from a per-seam seeded stream.
    ``plan``: ``{seam: [call indices]}`` — fire exactly on those
    1-based invocation counts of that seam (deterministic scripting
    for tests; composes with ``rates``). For multi-worker runs a plan
    entry may instead be ``{worker: [call indices]}`` — the indices
    then count THAT worker's own calls of the seam (callers pass
    ``fire(seam, worker=w)``), so "preempt exactly worker 2 at its 5th
    step" is scriptable and the other workers' streams are untouched.
    ``corrupting``: seams whose fires raise
    :class:`CorruptedStateFault` instead of :class:`TransientFault`.
    ``slow_ms``: ``{seam: milliseconds}`` — a fire at one of these
    seams SLEEPS instead of raising (per-seam tail latency; models a
    slow disk at ``checkpoint_io``, a slow device at ``device_step``).

    Worker scoping: ``fire(seam, worker=w)`` keeps a per-(seam, worker)
    call counter and a per-(seed, seam, worker) random stream, so each
    worker's fault pattern is independent of the others' interleaving —
    the fleet-wide analog of the per-seam-stream rule above. A flat
    plan list applies to EVERY worker (each at its own call counts);
    the dict form targets workers individually. Worker-scoped calls
    also bump the seam's aggregate counters, so ``snapshot()`` totals
    stay meaningful either way.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 plan: Optional[Dict[str, Iterable[int]]] = None,
                 corrupting: Iterable[str] = (),
                 latency_ms: float = 1.0,
                 slow_ms: Optional[Dict[str, float]] = None):
        self.seed = int(seed)
        self.rates = {s: float(p) for s, p in (rates or {}).items()}
        self.plan = {}
        self.worker_plan: Dict[str, Dict[int, frozenset]] = {}
        for s, idx in (plan or {}).items():
            if isinstance(idx, dict):
                self.worker_plan[s] = {
                    int(w): frozenset(int(i) for i in ii)
                    for w, ii in idx.items()}
                self.plan[s] = frozenset()
            else:
                self.plan[s] = frozenset(int(i) for i in idx)
        self.corrupting = frozenset(corrupting)
        self.slow_ms = {s: float(ms) for s, ms in (slow_ms or {}).items()}
        unknown = [s for s in (set(self.rates) | set(self.plan)
                               | set(self.worker_plan)
                               | self.corrupting | set(self.slow_ms))
                   if s not in SEAMS]
        if unknown:
            raise ValueError(f"unknown fault seams {sorted(unknown)}; "
                             f"valid seams: {list(SEAMS)}")
        for s, p in self.rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for seam {s!r} must be in "
                                 f"[0, 1], got {p}")
        self.latency_ms = float(latency_ms)
        self._lock = threading.Lock()
        self._calls = {s: 0 for s in SEAMS}
        self._fired = {s: 0 for s in SEAMS}
        # one stream PER SEAM, keyed by (seed, seam name): the decision
        # at call #n of a seam depends only on n — never on how many
        # times OTHER seams fired in between — so a workload replays
        # the same fault pattern regardless of thread interleaving
        self._rngs = {s: np.random.RandomState(
            (self.seed * 1_000_003 + zlib.crc32(s.encode())) & 0xFFFFFFFF)
            for s in self.rates}
        # worker-scoped counters/streams, materialized on first use
        self._wcalls: Dict[tuple, int] = {}
        self._wfired: Dict[tuple, int] = {}
        self._wrngs: Dict[tuple, np.random.RandomState] = {}

    def _worker_rng(self, seam: str, worker: int) -> np.random.RandomState:
        key = (seam, worker)
        rng = self._wrngs.get(key)
        if rng is None:
            rng = np.random.RandomState(
                (self.seed * 1_000_003
                 + zlib.crc32(f"{seam}#{worker}".encode())) & 0xFFFFFFFF)
            self._wrngs[key] = rng
        return rng

    def fire(self, seam: str, worker: Optional[int] = None) -> bool:
        """Consult the injector at ``seam``. Returns False (no fault)
        or True (``latency``/``slow_ms`` seams slept /
        ``client_disconnect`` should be interpreted by the caller);
        the error seams raise instead of returning True. With
        ``worker=``, call counts and random draws come from that
        worker's OWN stream (see class docstring)."""
        if seam not in self._calls:
            raise ValueError(f"unknown seam {seam!r}")
        with self._lock:
            self._calls[seam] += 1
            if worker is None:
                n = self._calls[seam]
                hit = n in self.plan.get(seam, ())
                if not hit and seam in self.rates:
                    hit = bool(self._rngs[seam].random_sample()
                               < self.rates[seam])
            else:
                worker = int(worker)
                key = (seam, worker)
                n = self._wcalls.get(key, 0) + 1
                self._wcalls[key] = n
                wplan = self.worker_plan.get(seam)
                if wplan is not None:
                    hit = n in wplan.get(worker, ())
                else:
                    # a flat plan applies to every worker, each
                    # counting its own calls
                    hit = n in self.plan.get(seam, ())
                if not hit and seam in self.rates:
                    hit = bool(self._worker_rng(seam, worker)
                               .random_sample() < self.rates[seam])
                if hit:
                    self._wfired[key] = self._wfired.get(key, 0) + 1
            if not hit:
                return False
            self._fired[seam] += 1
        if seam in self.slow_ms:
            time.sleep(self.slow_ms[seam] / 1e3)
            return True
        if seam == "latency":
            time.sleep(self.latency_ms / 1e3)
            return True
        if seam == "client_disconnect":
            return True
        if seam == "preempt":
            raise PreemptionFault(
                f"injected preemption at step boundary (call #{n})")
        if seam in self.corrupting:
            raise CorruptedStateFault(
                f"injected cache-corrupting fault at {seam!r} "
                f"(call #{n})")
        raise TransientFault(
            f"injected transient fault at {seam!r} (call #{n})")

    def snapshot(self) -> Dict:
        """Per-seam call/fire counters (for tests and the bench chaos
        probes' reports). ``by_worker`` appears once any worker-scoped
        call happened: ``{seam: {worker: {"calls": n, "fired": m}}}``."""
        with self._lock:
            out = {"calls": dict(self._calls),
                   "fired": dict(self._fired)}
            if self._wcalls:
                by = {}
                for (seam, w), n in self._wcalls.items():
                    by.setdefault(seam, {})[w] = {
                        "calls": n,
                        "fired": self._wfired.get((seam, w), 0)}
                out["by_worker"] = by
            return out


def poll_until_idle(is_idle: Callable[[], bool], timeout_s: float,
                    quiet_obs: int = 3, poll_s: float = 0.02) -> bool:
    """True once ``is_idle()`` holds for ``quiet_obs`` CONSECUTIVE
    observations before the deadline. A single idle glimpse is not
    enough: a request can sit between ``queue.get()`` and its device
    call / slot claim for a moment with every queue already empty.
    Shared by the engine and batcher drain loops so the quiet
    heuristic cannot drift between them."""
    deadline = time.monotonic() + timeout_s
    quiet = 0
    while time.monotonic() < deadline:
        if is_idle():
            quiet += 1
            if quiet >= quiet_obs:
                return True
        else:
            quiet = 0
        time.sleep(poll_s)
    return False
