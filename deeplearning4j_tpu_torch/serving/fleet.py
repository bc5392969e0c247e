"""Replica fleet tier of the port (counterpart of
``deeplearning4j_tpu/serving/fleet.py``, lifted: the module uses no
framework, so the port carries its own copy): occupancy-aware routing,
straggler hedging, and zero-loss rolling restarts over N
:class:`~.InferenceServer` replicas.

One :class:`~.InferenceServer` is a replica, not a service. Here N
in-process (or remote) replicas sit behind a :class:`FleetRouter`,
testable on the CPU because the replicas speak stdlib HTTP on
loopback; on the card every in-process replica's engines replay their
own CUDA graphs on the one device.

Layers::

    HTTP clients ──► FleetRouter ──► Replica (InferenceServer) x N
                        │               ▲
                        └── ReplicaFleet┘  (membership, health polls,
                                            cordon, rolling restart)

- :class:`ReplicaFleet` — membership + health. A poll loop reads each
  replica's ``GET /healthz`` and the compact ``summary`` block of
  ``GET /stats`` (live occupancy, queue depth, draining flag). A
  replica that fails ``eject_after`` consecutive polls — connection
  refused, or ``/healthz`` 503 because a scheduler loop is wedged —
  is EJECTED from routing; it is re-admitted automatically on the
  first clean poll. Draining replicas stay members (their in-flight
  work must finish) but stop receiving new work.
- :class:`FleetRouter` — request routing. Picks the eligible replica
  with the lowest occupancy score (router-local in-flight count plus
  the last-polled ``summary.load`` = queued + active rows/slots), NOT
  round-robin, so a replica bogged down by slow requests or direct
  traffic naturally stops attracting load. A 503 shed / draining
  answer or a connection failure is retried against another replica;
  slow predicts are HEDGED: after ``hedge_after_ms`` with no response
  the same request is re-issued to a second replica and the first
  response wins, under a token-bucket retry budget so hedges can never
  amplify an overload.
- Backpressure + circuit breaking: a 503 shed answer's
  ``Retry-After`` becomes a per-replica routing COOLDOWN (capped at
  ``cooldown_cap_s``). ``breaker_threshold`` CONSECUTIVE sheds trip a
  circuit breaker distinct from health ejection (the replica is alive
  and healthy, just overloaded): the breaker holds ``open`` for
  ``breaker_open_s``, then goes ``half_open`` and admits one probe
  request per window — a 2xx answer to a request dispatched AFTER
  the latest shed closes it (a 200 already in flight when the shed
  landed is stale evidence and changes nothing), another shed
  re-opens it. Counters: ``sheds``, ``cooldowns``, ``breaker_trips``,
  ``breaker_probes``, ``breaker_recoveries``, plus a ``goodput``
  ratio (responses/requests) in the snapshot.
- :meth:`ReplicaFleet.rolling_restart` — one replica at a time is
  cordoned (router steers new work away), drained (in-flight work
  finishes), stopped, rebuilt via its ``factory``, health-checked,
  and re-admitted. Requests racing into the drain window get 503 +
  ``Retry-After`` from the replica and are transparently retried by
  the router against a live peer — the fleet as a whole loses zero
  accepted requests and, with deterministic seeds, generation returns
  the restart-free tokens (test-asserted).

Everything is observable at the router's ``GET /stats``: per-replica
occupancy/state plus fleet counters (``requests``, ``responses``,
``hedges``/``hedges_won``/``hedge_budget_denied``, ``retries``,
``requests_lost``, ``ejections``, ``readmissions``, ``restarts``).
"""
from __future__ import annotations

import collections
import http.client
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs

from ..faults import poll_until_idle
from ..profiler import Reservoir
from ..tracing import Tracer, new_request_id
from .engine import ServingError
from .metrics import prometheus_text

#: transport-level failures that justify trying another replica — the
#: predict path is stateless and generation is seed-deterministic, so
#: re-executing elsewhere is always semantically safe. NOTE: a socket
#: TIMEOUT (TimeoutError ⊂ OSError) is carved back out by the callers:
#: the replica is still WORKING on the request, so re-dispatching
#: would run it twice concurrently and penalize a healthy replica —
#: timeouts map to a terminal 504 instead
_RETRYABLE_EXC = (ConnectionError, OSError, http.client.HTTPException)


def _timeout_response(timeout_s: float):
    """Terminal (status, headers, body) for a router-side socket
    timeout: 504, never retried, never counted against the replica."""
    return (504, {}, json.dumps(
        {"error": f"no replica response within {timeout_s:g}s "
                  "(router socket timeout)"}).encode())

_JSON_HEADERS = {"Content-Type": "application/json"}


class FleetError(ServingError):
    """Fleet-level failure (no replica could take the request)."""


class NoReplicasError(FleetError):
    """No eligible replica is available (HTTP 503 + Retry-After)."""


def _get_json(host: str, port: int, path: str,
              timeout: float) -> Tuple[int, Dict]:
    """One GET on a fresh connection -> (status, parsed body or {})."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        raw = r.read()
        try:
            body = json.loads(raw) if raw else {}
        except ValueError:
            body = {}
        return r.status, body
    finally:
        conn.close()


class FleetMetrics:
    """Fleet-level counters (same threading discipline as
    :class:`~.metrics.ServingMetrics`: scalar counters via
    :meth:`inc`, never ``+=`` — HTTP handler threads, hedge arms, the
    poll loop, and rolling restarts all write here)."""

    def __init__(self, latency_window: int = 8192):
        self._lock = threading.Lock()
        self.requests = 0            # client requests entering the router
        self.responses = 0           # terminal 2xx returned
        self.client_errors = 0       # terminal 4xx passed through
        self.server_errors = 0       # terminal 5xx passed through
        self.routed = 0              # dispatch attempts to replicas
        self.retries = 0             # re-dispatches after 503/conn fail
        self.hedges = 0              # hedge arms launched
        self.hedges_won = 0          # hedge arm answered first
        self.hedge_budget_denied = 0  # hedge wanted, budget empty
        self.requests_lost = 0       # retryable failure, no replica left
        self.ejections = 0           # health-gated removals
        self.readmissions = 0        # recoveries back into routing
        self.restarts = 0            # rolling-restart cycles completed
        self.streams = 0             # streaming generations proxied
        self.sheds = 0               # 503 shed answers seen from replicas
        self.cooldowns = 0           # Retry-After cooldowns activated
        self.breaker_trips = 0       # closed -> open transitions
        self.breaker_probes = 0      # half-open probe requests admitted
        self.breaker_recoveries = 0  # open/half-open -> closed
        self.session_affinity_hits = 0  # session routed to its replica
        self.latency_ms = Reservoir(latency_window)

    def inc(self, field: str, n: int = 1):
        """Thread-safe counter increment."""
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> Dict:
        return {
            "requests": self.requests,
            "responses": self.responses,
            "client_errors": self.client_errors,
            "server_errors": self.server_errors,
            "routed": self.routed,
            "retries": self.retries,
            "hedges": self.hedges,
            "hedges_won": self.hedges_won,
            "hedge_budget_denied": self.hedge_budget_denied,
            "requests_lost": self.requests_lost,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "restarts": self.restarts,
            "streams": self.streams,
            "sheds": self.sheds,
            "cooldowns": self.cooldowns,
            "breaker_trips": self.breaker_trips,
            "breaker_probes": self.breaker_probes,
            "breaker_recoveries": self.breaker_recoveries,
            "session_affinity_hits": self.session_affinity_hits,
            # share of accepted requests that came back 2xx — the
            # overload-robustness headline: under graceful shedding
            # this stays near 1.0 for ADMITTED work even at 2x load
            "goodput": round(self.responses / self.requests, 4)
            if self.requests else 1.0,
            "latency_ms": {k: round(v, 3) for k, v in
                           self.latency_ms.snapshot().items()},
        }


class Replica:
    """One fleet member: address + live routing state.

    In-process replicas carry their :class:`~.InferenceServer` in
    ``server`` and (for rolling restarts) a zero-arg ``factory`` that
    builds a fresh, warmed server. Remote replicas are just
    (host, port) — they participate in routing and health but cannot
    be restarted by :meth:`ReplicaFleet.rolling_restart`.
    """

    def __init__(self, replica_id: str, host: str, port: int,
                 server=None, factory: Optional[Callable[[], Any]] = None):
        self.id = replica_id
        self.host = host
        self.port = int(port)
        self.server = server
        self.factory = factory
        self._lock = threading.Lock()
        # membership state (poll loop + router failure notes mutate it)
        self.admitted = True      # health-gated: False = ejected
        self.cordoned = False     # operator/rolling-restart exclusion
        self.ready = True         # replica-side readiness (draining?)
        self.fails = 0            # consecutive failed polls/dispatches
        self.ejected_ever = False
        # routing state
        self.in_flight = 0        # router-tracked live dispatches
        self.routed = 0           # total dispatches sent here
        self.summary: Dict = {}   # last-polled /stats summary block
        self.last_poll: Optional[float] = None
        # backpressure state (distinct from health: the replica is
        # alive, it just told us to back off)
        self.cooldown_until = 0.0    # Retry-After routing exclusion
        self.shed_at = 0.0           # monotonic time of the last shed
        self.consecutive_sheds = 0   # 503 streak -> trips the breaker
        self.breaker_tripped = False
        self.breaker_until = 0.0     # open until; half-open after
        self.probe_at = 0.0          # last half-open probe launch

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def eligible(self) -> bool:
        """May receive NEW work right now (health/membership view —
        backpressure is layered on top, see
        :meth:`ReplicaFleet.routable`)."""
        return self.admitted and not self.cordoned and self.ready

    def breaker_state(self, now: Optional[float] = None) -> str:
        """``closed`` | ``open`` | ``half_open``."""
        if not self.breaker_tripped:
            return "closed"
        now = time.monotonic() if now is None else now
        return "open" if now < self.breaker_until else "half_open"

    def reset_backpressure(self):
        """Forget cooldown/breaker state — a rebuilt replica (rolling
        restart) starts with a clean slate; its old overload history
        belongs to the process that no longer exists. Caller must NOT
        hold ``_lock``."""
        with self._lock:
            self.cooldown_until = 0.0
            self.shed_at = 0.0
            self.consecutive_sheds = 0
            self.breaker_tripped = False
            self.breaker_until = 0.0
            self.probe_at = 0.0

    def score(self) -> int:
        """Occupancy score the router minimizes: the router's own
        live in-flight count (instantaneous) plus the replica's
        last-polled ``summary.load`` (queued + active rows/slots —
        includes traffic from other routers or direct clients). The
        two overlap while a poll is stale; the ordering they induce is
        what matters, not the absolute value."""
        return self.in_flight + int(self.summary.get("load", 0))

    def begin(self):
        with self._lock:
            self.in_flight += 1
            self.routed += 1

    def end(self):
        with self._lock:
            self.in_flight -= 1

    def snapshot(self) -> Dict:
        now = time.monotonic()
        with self._lock:
            return {
                "id": self.id,
                "address": self.address,
                "admitted": self.admitted,
                "cordoned": self.cordoned,
                "ready": self.ready,
                "eligible": self.eligible(),
                "fails": self.fails,
                "in_flight": self.in_flight,
                "requests_routed": self.routed,
                "score": self.in_flight + int(self.summary.get("load", 0)),
                "breaker": self.breaker_state(now),
                "cooling": now < self.cooldown_until,
                "consecutive_sheds": self.consecutive_sheds,
                "summary": self.summary,
            }


class ReplicaFleet:
    """Membership + health for a set of replicas.

    ``poll_interval_s`` drives the background health loop (pass
    ``None`` to disable it and call :meth:`poll_now` explicitly —
    deterministic tests do). ``eject_after`` consecutive failed polls
    (connection failure or a wedged ``/healthz``) eject a replica from
    routing; the first clean poll re-admits it.

    Backpressure knobs: ``breaker_threshold`` consecutive 503 sheds
    trip a replica's circuit breaker; it holds open ``breaker_open_s``
    then admits one half-open probe per window. A shed's Retry-After
    is honored as a routing cooldown, capped at ``cooldown_cap_s`` so
    a replica advertising a huge backoff cannot exile itself.
    """

    def __init__(self, poll_interval_s: Optional[float] = 0.25,
                 eject_after: int = 2, probe_timeout_s: float = 5.0,
                 breaker_threshold: int = 3, breaker_open_s: float = 1.0,
                 cooldown_cap_s: float = 5.0):
        self.metrics = FleetMetrics()
        self.eject_after = int(eject_after)
        self.probe_timeout_s = float(probe_timeout_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_open_s = float(breaker_open_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._next_id = 0
        self._running = True
        self._poll_thread: Optional[threading.Thread] = None
        if poll_interval_s is not None:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True, name="fleet-health")
            self._poll_thread.start()

    # -- membership ----------------------------------------------------
    def add(self, server=None, host: Optional[str] = None,
            port: Optional[int] = None,
            factory: Optional[Callable[[], Any]] = None,
            replica_id: Optional[str] = None) -> Replica:
        """Register a replica: an in-process ``InferenceServer`` (pass
        ``server=``, plus ``factory=`` to make it restartable), or a
        remote one (pass ``host=``/``port=``)."""
        if server is not None:
            host, port = server.host, server.port
        if host is None or port is None:
            raise ValueError("pass server= or host=/port=")
        with self._lock:
            if replica_id is None:
                replica_id = f"r{self._next_id}"
                self._next_id += 1
            if any(r.id == replica_id for r in self._replicas):
                raise ValueError(f"replica id {replica_id!r} already "
                                 "registered")
            rep = Replica(replica_id, host, port, server=server,
                          factory=factory)
            self._replicas.append(rep)
            return rep

    def remove(self, replica_id: str) -> Replica:
        with self._lock:
            for i, r in enumerate(self._replicas):
                if r.id == replica_id:
                    return self._replicas.pop(i)
        raise KeyError(f"unknown replica {replica_id!r}")

    def get(self, replica_id: str) -> Replica:
        with self._lock:
            for r in self._replicas:
                if r.id == replica_id:
                    return r
        raise KeyError(f"unknown replica {replica_id!r}")

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def eligible(self) -> List[Replica]:
        return [r for r in self.replicas() if r.eligible()]

    def cordon(self, replica_id: str):
        """Exclude a replica from NEW work (in-flight work finishes);
        the rolling restart's first move, also useful by hand."""
        self.get(replica_id).cordoned = True

    def uncordon(self, replica_id: str):
        self.get(replica_id).cordoned = False

    # -- health --------------------------------------------------------
    def _poll_loop(self):
        while self._running:
            try:
                self.poll_now()
            except Exception:   # noqa: BLE001 — health must not die
                pass
            time.sleep(self.poll_interval_s)

    def poll_now(self):
        """One synchronous health/occupancy sweep over every replica
        (the background loop calls this; tests and operators can too
        for a deterministic refresh)."""
        for rep in self.replicas():
            self._poll_replica(rep)

    def _poll_replica(self, rep: Replica):
        ok = False
        summary: Dict = {}
        try:
            hz, _ = _get_json(rep.host, rep.port, "/healthz",
                              self.probe_timeout_s)
            st, stats = _get_json(rep.host, rep.port, "/stats",
                                  self.probe_timeout_s)
            # a wedged scheduler (healthz 503) is as ejectable as a
            # dead socket; /stats failing means we can't route on it
            ok = hz == 200 and st == 200
            if ok:
                summary = stats.get("summary") or {}
        except _RETRYABLE_EXC:
            ok = False
        rep.last_poll = time.monotonic()
        if ok:
            readmit = False
            with rep._lock:
                rep.summary = summary
                rep.ready = bool(summary.get("ready", True))
                rep.fails = 0
                if not rep.admitted:
                    rep.admitted = True
                    readmit = True
            if readmit:
                self.metrics.inc("readmissions")
        elif not rep.cordoned:
            # a cordoned replica is EXPECTED to be dark (it is being
            # restarted); counting that window as an ejection would
            # turn every rolling restart into a fake health incident
            self.note_failure(rep)

    def note_failure(self, rep: Replica):
        """Record one failed contact (poll or live dispatch); ejects
        after ``eject_after`` consecutive failures. The router calls
        this on connection errors so ejection doesn't wait for the
        next poll tick. Cordoned replicas are exempt here too: a
        racer that picked the victim just before the cordon and then
        hit its dead port must not turn a rolling restart into a
        fake ejection."""
        if rep.cordoned:
            return
        eject = False
        with rep._lock:
            rep.fails += 1
            if rep.admitted and rep.fails >= self.eject_after:
                rep.admitted = False
                rep.ejected_ever = True
                eject = True
        if eject:
            self.metrics.inc("ejections")

    # -- backpressure / circuit breaking -------------------------------
    def routable(self, rep: Replica,
                 now: Optional[float] = None) -> bool:
        """May this replica receive a request RIGHT NOW? Eligibility
        (health/cordon/ready) AND not in a Retry-After cooldown AND
        the breaker admits traffic. ``half_open`` answers True only
        while the current window's probe slot is unclaimed — the
        router must then :meth:`claim_probe` before dispatching."""
        if not rep.eligible():
            return False
        now = time.monotonic() if now is None else now
        if now < rep.cooldown_until:
            return False
        state = rep.breaker_state(now)
        if state == "open":
            return False
        if state == "half_open":
            return now - rep.probe_at >= self.breaker_open_s
        return True

    def claim_probe(self, rep: Replica,
                    now: Optional[float] = None) -> bool:
        """Atomically claim the half-open probe slot (one probe per
        ``breaker_open_s`` window); False means another thread beat
        us to it and THIS request should pick elsewhere."""
        now = time.monotonic() if now is None else now
        with rep._lock:
            if now - rep.probe_at < self.breaker_open_s:
                return False
            rep.probe_at = now
        self.metrics.inc("breaker_probes")
        return True

    def note_shed(self, rep: Replica,
                  retry_after_s: Optional[float] = None):
        """A 503 shed came back from this replica: honor Retry-After
        as a routing cooldown (capped) and count one strike toward
        the breaker. A shed while the breaker is already tripped —
        a failed half-open probe — re-opens the window."""
        now = time.monotonic()
        try:
            cooldown = float(retry_after_s)
        except (TypeError, ValueError):
            cooldown = 1.0
        cooldown = min(max(cooldown, 0.0), self.cooldown_cap_s)
        tripped = False
        with rep._lock:
            was_cooling = now < rep.cooldown_until
            rep.cooldown_until = max(rep.cooldown_until, now + cooldown)
            rep.shed_at = now
            rep.consecutive_sheds += 1
            if rep.breaker_tripped:
                rep.breaker_until = now + self.breaker_open_s
            elif rep.consecutive_sheds >= self.breaker_threshold:
                rep.breaker_tripped = True
                rep.breaker_until = now + self.breaker_open_s
                tripped = True
        self.metrics.inc("sheds")
        if not was_cooling:
            self.metrics.inc("cooldowns")
        if tripped:
            self.metrics.inc("breaker_trips")

    def note_ok(self, rep: Replica,
                dispatched_at: Optional[float] = None):
        """A 2xx answer from this replica: the shed streak is broken;
        a tripped breaker closes (successful half-open probe); any
        residual cooldown is lifted — the replica is demonstrably
        serving again. ``dispatched_at`` (``time.monotonic()`` at
        send time) guards against stale evidence: a 200 for a request
        dispatched BEFORE the replica's latest shed was admitted
        before the overload signal and proves nothing — it must not
        cancel a fresh cooldown and route traffic straight back."""
        recovered = False
        with rep._lock:
            if dispatched_at is not None and dispatched_at < rep.shed_at:
                return
            rep.consecutive_sheds = 0
            rep.cooldown_until = 0.0
            if rep.breaker_tripped:
                rep.breaker_tripped = False
                rep.breaker_until = 0.0
                recovered = True
        if recovered:
            self.metrics.inc("breaker_recoveries")

    # -- rolling restart ----------------------------------------------
    def rolling_restart(self, drain_timeout_s: float = 30.0,
                        ready_timeout_s: float = 120.0) -> bool:
        """Restart every restartable replica ONE AT A TIME with zero
        accepted-request loss: cordon (router steers new work away,
        racers get 503 + Retry-After and are retried elsewhere), wait
        for router-tracked in-flight work to finish, ``drain()`` +
        ``stop()`` the server, rebuild it via ``factory`` (which
        should warm the new server before returning), wait until the
        new process answers ``/readyz`` and ``/healthz``, re-admit,
        uncordon, move on. Replicas without a ``factory`` (remote, or
        added without one) are skipped. Returns True when every
        restarted replica drained cleanly and came back ready within
        its budget."""
        ok_all = True
        for rep in self.replicas():
            if rep.factory is None:
                continue
            self.cordon(rep.id)
            try:
                # the router decrements in_flight only after a
                # replica's response is fully back, so this wait plus
                # the server-side drain covers every accepted request
                poll_until_idle(lambda: rep.in_flight == 0,
                                drain_timeout_s)
                clean = True
                if rep.server is not None:
                    clean = bool(rep.server.drain(drain_timeout_s))
                    rep.server.stop()
                new = rep.factory()
                with rep._lock:
                    rep.server = new
                    rep.host = new.host
                    rep.port = int(new.port)
                    rep.summary = {}
                ready = self._wait_ready(rep, ready_timeout_s)
                # the rebuilt process never shed anything: start it
                # with a clean cooldown/breaker slate
                rep.reset_backpressure()
                with rep._lock:
                    rep.fails = 0
                    # a replacement that never answered /readyz within
                    # its budget must NOT be force-admitted: leave it
                    # ejected (the poll loop re-admits the moment it
                    # comes good; without a poll loop the False return
                    # is the operator's signal)
                    rep.admitted = ready
                    rep.ready = ready
                    if not ready:
                        rep.ejected_ever = True
                self.metrics.inc("restarts")
                if not ready:
                    self.metrics.inc("ejections")
                ok_all = ok_all and clean and ready
            except Exception:   # noqa: BLE001 — a failed rebuild
                # (factory raise, drain blow-up) must not leave a
                # dead address looking eligible, and must not abort
                # the restarts of the replicas AFTER this one
                with rep._lock:
                    rep.admitted = False
                    rep.ready = False
                    rep.ejected_ever = True
                self.metrics.inc("ejections")
                ok_all = False
            finally:
                self.uncordon(rep.id)
        return ok_all

    def _wait_ready(self, rep: Replica, timeout_s: float) -> bool:
        def probe() -> bool:
            try:
                rz, _ = _get_json(rep.host, rep.port, "/readyz",
                                  self.probe_timeout_s)
                hz, _ = _get_json(rep.host, rep.port, "/healthz",
                                  self.probe_timeout_s)
                return rz == 200 and hz == 200
            except _RETRYABLE_EXC:
                return False
        return poll_until_idle(probe, timeout_s, quiet_obs=1)

    def snapshot(self) -> Dict:
        reps = [r.snapshot() for r in self.replicas()]
        s = self.metrics.snapshot()
        s["replicas"] = reps
        s["eligible_replicas"] = sum(1 for r in reps if r["eligible"])
        s["fleet_load"] = sum(r["score"] for r in reps)
        # replica-side shed totals (from the polled summaries) — the
        # fleet-wide view of admission-control pressure, including
        # sheds served to clients that bypassed this router
        s["fleet_shed"] = sum(int(r["summary"].get("shed", 0) or 0)
                              for r in reps)
        return s

    def stop(self, stop_replicas: bool = False):
        self._running = False
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
        if stop_replicas:
            for rep in self.replicas():
                if rep.server is not None:
                    rep.server.stop()


class _FleetStream:
    """Iterator over a proxied ndjson stream. :meth:`close` (also run
    by ``__del__`` and on exhaustion) closes the upstream connection —
    aborting the generation and freeing the backing replica's
    slot/blocks — and releases the router's in-flight count. A bare
    generator could leak the in-flight count if abandoned before the
    first ``next()``; this class cannot."""

    def __init__(self, rep: Replica, conn, resp):
        self._rep = rep
        self._conn = conn
        self._resp = resp
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        if self._closed:
            raise StopIteration
        try:
            line = self._resp.readline()
            while line and not line.strip():
                line = self._resp.readline()
        except Exception:
            self.close()
            raise
        if not line:
            self.close()
            raise StopIteration
        return json.loads(line)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._conn.close()
        self._rep.end()

    def __del__(self):
        self.close()


class _ConnPool:
    """Keep-alive HTTP connections to replicas, checked out per
    request (one connection is never shared by two threads at once).
    Bounded per address; a restarted replica usually changes port, and
    a stale keep-alive on the same port surfaces as a retryable error
    handled by the caller."""

    def __init__(self, timeout_s: float, max_per_key: int = 32):
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int], List] = {}
        self.timeout_s = float(timeout_s)
        self.max_per_key = int(max_per_key)

    def take(self, host: str, port: int):
        with self._lock:
            stack = self._idle.get((host, port))
            if stack:
                return stack.pop()
        return http.client.HTTPConnection(host, port,
                                          timeout=self.timeout_s)

    def give(self, host: str, port: int, conn):
        with self._lock:
            stack = self._idle.setdefault((host, port), [])
            if len(stack) < self.max_per_key:
                stack.append(conn)
                return
        conn.close()

    def prune(self, live_keys):
        """Close and drop idle connections to addresses no longer in
        the fleet — every rolling restart moves a replica to a fresh
        ephemeral port, and without pruning the old address' stack
        would strand up to ``max_per_key`` open sockets forever."""
        with self._lock:
            dead = [k for k in self._idle if k not in live_keys]
            stacks = [self._idle.pop(k) for k in dead]
        for stack in stacks:
            for conn in stack:
                conn.close()

    def close_all(self):
        with self._lock:
            stacks, self._idle = self._idle, {}
        for stack in stacks.values():
            for conn in stack:
                conn.close()


class FleetRouter:
    """Occupancy-aware request router over a :class:`ReplicaFleet`.

    Python surface: :meth:`post` (predict/generate JSON in, (status,
    body) out), :meth:`stream` (streamed generation as an iterator of
    parsed ndjson objects), :meth:`stats`. HTTP surface (optional,
    :meth:`serve`): the same route table as one replica — ``POST
    /predict``, ``/generate``, ``/v1/models/<name>/predict|generate``
    — plus fleet-level ``GET /stats``, ``/healthz``, ``/readyz``,
    and a proxied ``GET /v1/models``, so a fleet drops in wherever a
    single replica stood.

    Hedging (predict only — it is stateless, so duplicating work is
    always safe): when the chosen replica hasn't answered within
    ``hedge_after_ms``, the SAME request is issued to the
    next-best replica and the first response wins. A token bucket
    caps amplification: ``hedge_budget_burst`` tokens to start,
    refilled ``hedge_budget_ratio`` per completed request, one token
    per hedge — so hedges can never exceed ``burst + ratio *
    requests`` no matter how sick the fleet is. ``hedge_after_ms=None``
    (default) disables hedging.

    Shed retry: a 503 (queue full / draining) or a connection failure
    excludes that replica for this request and retries the next-best
    one, up to ``max_attempts`` (default: every currently-eligible
    replica once). Only transport-level and shed failures are
    retried; 400/404/500/504 are the request's own fate and pass
    through unchanged.

    ``hedge_generate=True`` extends hedging to non-streaming generate
    requests — generation is seed-deterministic, so a duplicated
    dispatch wastes decode steps but never changes the answer.
    ``cooldown_wait_s>0`` lets a request that found every replica in
    a Retry-After cooldown WAIT (bounded, once) for the nearest
    cooldown to lapse instead of failing straight to 503.

    Tracing (``tracing=True``, docs/observability.md): router-side
    spans — ``pick``, ``cooldown_wait``, ``dispatch``, ``retry``,
    ``hedge`` — are recorded under the propagated request id, so one
    trace stitches the router's view onto the winning replica's
    queue/admission/prefill/decode spans. Hedge arms share the trace
    id with distinct span ids; the losing arm is marked
    ``discarded``.
    """

    def __init__(self, fleet: ReplicaFleet,
                 hedge_after_ms: Optional[float] = None,
                 hedge_budget_ratio: float = 0.1,
                 hedge_budget_burst: float = 4.0,
                 max_attempts: Optional[int] = None,
                 timeout_s: float = 60.0,
                 hedge_generate: bool = False,
                 cooldown_wait_s: float = 0.0,
                 tracing: bool = False,
                 trace_ring: int = 256,
                 trace_slow_ms: float = 1000.0):
        self.fleet = fleet
        self.metrics = fleet.metrics
        self.hedge_after_ms = (None if hedge_after_ms is None
                               else float(hedge_after_ms))
        self.hedge_budget_ratio = float(hedge_budget_ratio)
        self.hedge_budget_burst = float(hedge_budget_burst)
        self.max_attempts = max_attempts
        self.timeout_s = float(timeout_s)
        self.hedge_generate = bool(hedge_generate)
        self.cooldown_wait_s = float(cooldown_wait_s)
        self.tracer = Tracer(enabled=bool(tracing), ring=trace_ring,
                             slow_ms=trace_slow_ms)
        self._log_stream = None
        self._log_lock = threading.Lock()
        self._budget_lock = threading.Lock()
        self._budget = self.hedge_budget_burst
        self._pool = _ConnPool(timeout_s)
        self._live_addrs: Set[Tuple[str, int]] = set()
        self._rr = 0               # tie-break rotation among equals
        self._rr_lock = threading.Lock()
        # session affinity: session_id -> replica id, LRU-bounded. A
        # session's KV blocks live on ONE replica (its session store),
        # so routing the next turn there is the difference between a
        # prefix hit and a full re-prefill. Advisory only: when the
        # mapped replica is unroutable the request falls back to the
        # normal pick and the session re-pins wherever it lands.
        self._affinity: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._affinity_cap = 4096
        self._affinity_lock = threading.Lock()
        self.httpd = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._http_thread: Optional[threading.Thread] = None
        self._aio = None

    # -- replica selection --------------------------------------------
    def _pick(self, excluded: Set[str],
              prefer: Optional[str] = None) -> Optional[Replica]:
        reps = self.fleet.replicas()
        addrs = {(r.host, r.port) for r in reps}
        if addrs != self._live_addrs:
            # membership/port change (restart, eject+rebuild): drop
            # pooled keep-alives to addresses that no longer exist
            self._live_addrs = addrs
            self._pool.prune(addrs)
        now = time.monotonic()
        cands = [r for r in reps
                 if r.id not in excluded and self.fleet.routable(r, now)]
        if not cands:
            return None
        if prefer is not None:
            # session affinity: the preferred replica holds this
            # session's KV blocks — take it whenever it is routable,
            # bypassing the occupancy score (a warm prefix beats a
            # marginally shorter queue)
            for r in cands:
                if r.id != prefer:
                    continue
                if r.breaker_state(now) != "half_open" \
                        or self.fleet.claim_probe(r, now):
                    self.metrics.inc("session_affinity_hits")
                    return r
                break
        with self._rr_lock:
            self._rr += 1
            base = self._rr
        # min occupancy score; rotate among score ties so equal
        # replicas share load instead of the list head taking it all
        n = len(cands)
        best = min(range(n),
                   key=lambda i: (cands[i].score(), (i + base) % n))
        rep = cands[best]
        if rep.breaker_state(now) == "half_open" \
                and not self.fleet.claim_probe(rep, now):
            # another thread took this window's probe slot; this
            # request must look elsewhere (bounded: each recursion
            # excludes one replica)
            return self._pick(excluded | {rep.id})
        return rep

    # -- session affinity ---------------------------------------------
    def _affinity_get(self, session: Optional[str]) -> Optional[str]:
        if session is None:
            return None
        with self._affinity_lock:
            rid = self._affinity.get(session)
            if rid is not None:
                self._affinity.move_to_end(session)
            return rid

    def _affinity_note(self, session: Optional[str], rep_id: str):
        if session is None:
            return
        with self._affinity_lock:
            self._affinity[session] = rep_id
            self._affinity.move_to_end(session)
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)

    # -- hedge budget --------------------------------------------------
    def _take_budget(self) -> bool:
        with self._budget_lock:
            if self._budget >= 1.0:
                self._budget -= 1.0
                return True
        self.metrics.inc("hedge_budget_denied")
        return False

    def _refill_budget(self):
        with self._budget_lock:
            self._budget = min(self.hedge_budget_burst,
                               self._budget + self.hedge_budget_ratio)

    # -- transport -----------------------------------------------------
    def _roundtrip(self, rep: Replica, path: str, body: bytes,
                   headers: Dict = None):
        """One POST to one replica -> (status, headers, data). Retries
        exactly once on a stale keep-alive connection; raises a
        retryable exception when the replica is genuinely
        unreachable."""
        send = (_JSON_HEADERS if not headers
                else {**_JSON_HEADERS, **headers})
        for fresh in (False, True):
            conn = (http.client.HTTPConnection(rep.host, rep.port,
                                               timeout=self.timeout_s)
                    if fresh else self._pool.take(rep.host, rep.port))
            try:
                conn.request("POST", path, body=body,
                             headers=send)
                resp = conn.getresponse()
                data = resp.read()
            except _RETRYABLE_EXC as e:
                conn.close()
                # a timeout means the replica is still computing —
                # retrying on a fresh connection would double the work
                if fresh or isinstance(e, TimeoutError):
                    raise
                continue
            self._pool.give(rep.host, rep.port, conn)
            return resp.status, dict(resp.getheaders()), data
        raise ConnectionError("unreachable")   # not reached

    def _tracked(self, rep: Replica, path: str, body: bytes,
                 headers: Dict = None):
        rep.begin()
        self.metrics.inc("routed")
        try:
            return self._roundtrip(rep, path, body, headers)
        finally:
            rep.end()

    @staticmethod
    def _retryable(out) -> bool:
        """A result worth trying another replica for: transport
        failure, or an explicit shed/draining 503."""
        return isinstance(out, Exception) or out[0] == 503

    def _note(self, rep: Replica, status: int, hdrs: Dict,
              dispatched_at: Optional[float] = None):
        """Feed the backpressure loop from one replica answer: a 503
        becomes a Retry-After cooldown + breaker strike; a 2xx to a
        request dispatched AFTER the latest shed breaks the streak
        (and closes a tripped breaker). Anything else — 4xx, 500,
        504, or a 200 for a request already in flight when the shed
        landed — proves neither overload nor recovery and leaves the
        backpressure state alone."""
        if status == 503:
            self.fleet.note_shed(rep, hdrs.get("Retry-After"))
        elif 200 <= status < 300:
            self.fleet.note_ok(rep, dispatched_at)

    # -- dispatch ------------------------------------------------------
    def post(self, path: str, payload) -> Tuple[int, Dict]:
        """Route one JSON request; returns (status, parsed body).
        Retries sheds/connection failures against other replicas;
        hedges slow predicts. 503 with no replica left to try counts
        as ``requests_lost``. A generate payload carrying
        ``session_id`` is routed with session affinity — towards the
        replica whose session store pinned that conversation's KV
        blocks."""
        session = (payload.get("session_id")
                   if isinstance(payload, dict) else None)
        if not isinstance(session, str) or not session:
            session = None
        status, _hdrs, data = self.post_raw(path,
                                            json.dumps(payload).encode(),
                                            session=session)
        try:
            body = json.loads(data) if data else {}
        except ValueError:
            body = {"error": "unparseable replica response"}
        return status, body

    def post_raw(self, path: str, body: bytes, headers: Dict = None,
                 trace=None, session: Optional[str] = None):
        """Bytes-in/bytes-out dispatch (the HTTP front-end's path):
        returns (status, response headers, response bytes).
        ``headers`` are forwarded to the replica on top of the JSON
        content type — the front-end uses this so request-scoped
        classification (``X-Priority``) survives the proxy hop, and
        ``X-Request-Id`` stitches router and replica traces. When the
        router's tracer is on and no ``trace`` was passed (library
        callers), a trace is minted here under the forwarded request
        id."""
        owned = None
        if trace is None:
            trace = owned = self.tracer.begin(
                (headers or {}).get("X-Request-Id"))
        out = self._dispatch(path, body, headers, trace, session)
        if owned is not None:
            self.tracer.finish(owned, error=out[0] >= 500)
        return out

    def _dispatch(self, path: str, body: bytes, headers: Dict,
                  trace, session: Optional[str] = None):
        self.metrics.inc("requests")
        is_gen = (path.rstrip("/").endswith("/generate")
                  or path == "/generate")
        hedge = (self.hedge_after_ms is not None
                 and (self.hedge_generate or not is_gen))
        t0 = time.perf_counter()
        excluded: Set[str] = set()
        last = None
        attempts = 0
        waited = False
        prefer = self._affinity_get(session)
        max_attempts = self.max_attempts or max(1, len(self.fleet.eligible()))
        while attempts < max_attempts:
            t_pick = time.perf_counter()
            rep = self._pick(excluded, prefer=prefer)
            if rep is None:
                if waited or self.cooldown_wait_s <= 0:
                    break
                # nothing routable RIGHT NOW — but a replica merely in
                # a Retry-After cooldown will take work again shortly;
                # wait (bounded, once per request) instead of failing
                waited = True
                wait_s = self._cooldown_remaining(excluded)
                if wait_s is None:
                    break
                wait_s = min(wait_s, self.cooldown_wait_s)
                t_w = time.perf_counter()
                time.sleep(wait_s)
                if trace is not None:
                    trace.span("cooldown_wait", t_start=t_w,
                               t_end=time.perf_counter())
                continue
            if trace is not None:
                trace.span("pick", t_start=t_pick,
                           t_end=time.perf_counter(), replica=rep.id,
                           attempt=attempts + 1)
            attempts += 1
            if attempts > 1:
                self.metrics.inc("retries")
                if trace is not None:
                    trace.span("retry", attempt=attempts,
                               replica=rep.id).end()
            out = (self._attempt_hedged(rep, path, body, excluded,
                                        headers, trace)
                   if hedge else self._attempt_plain(rep, path, body,
                                                     excluded, headers,
                                                     trace))
            if self._retryable(out):
                last = out
                continue
            status, hdrs, data = out
            self._refill_budget()
            self.metrics.latency_ms.record(
                (time.perf_counter() - t0) * 1e3)
            if 200 <= status < 300:
                self.metrics.inc("responses")
                # the finished turn's blocks are pinned on THIS
                # replica: steer the session's next turn back here
                self._affinity_note(session, rep.id)
            elif status < 500:
                self.metrics.inc("client_errors")
            else:
                self.metrics.inc("server_errors")
            return status, hdrs, data
        # every eligible replica shed or failed: the request is LOST
        # from the fleet's point of view (the client may retry later)
        self._refill_budget()
        self.metrics.inc("requests_lost")
        if isinstance(last, tuple):
            status, hdrs, data = last
            hdrs.setdefault("Retry-After", "1")
            return status, hdrs, data
        return 503, {"Retry-After": "1"}, json.dumps(
            {"error": "no replica available"}).encode()

    def _cooldown_remaining(self, excluded: Set[str]) -> Optional[float]:
        """Seconds until the NEAREST cooled-down (but otherwise
        eligible) replica becomes routable again; None when no
        replica is merely cooling — waiting would not help."""
        now = time.monotonic()
        best = None
        for rep in self.fleet.replicas():
            if rep.id in excluded or not rep.eligible():
                continue
            left = rep.cooldown_until - now
            if left > 0 and (best is None or left < best):
                best = left
        return best

    def _attempt_plain(self, rep: Replica, path: str, body: bytes,
                       excluded: Set[str], headers: Dict = None,
                       trace=None):
        """Single-arm dispatch in the calling thread."""
        t_dispatch = time.monotonic()
        span = (trace.span("dispatch", replica=rep.id)
                if trace is not None else None)
        try:
            out = self._tracked(rep, path, body, headers)
        except _RETRYABLE_EXC as e:
            if isinstance(e, TimeoutError):
                # the replica is still working — re-dispatching would
                # run the request twice and smear a healthy replica
                if span is not None:
                    span.end(status=504, error="socket timeout")
                return _timeout_response(self.timeout_s)
            self.fleet.note_failure(rep)
            excluded.add(rep.id)
            if span is not None:
                span.end(error=f"{type(e).__name__}: {e}")
            return e
        self._note(rep, out[0], out[1], t_dispatch)
        if span is not None:
            span.end(status=out[0])
        if out[0] == 503:
            excluded.add(rep.id)
        return out

    def _attempt_hedged(self, rep: Replica, path: str, body: bytes,
                        excluded: Set[str], headers: Dict = None,
                        trace=None):
        """Primary dispatch with an optional hedge arm: wait
        ``hedge_after_ms`` for the primary; if silent, re-issue to the
        next-best replica (budget permitting) and take whichever
        answers first. Returns the winning (status, headers, data),
        or a retryable failure when every launched arm failed.

        Both arms record spans on the SAME trace (span ids are
        per-trace atomic, so the concurrent arms need no extra
        locking); after the race the losing arm's span is marked
        ``discarded`` — the waste the hedge budget bounds, visible
        per-request."""
        results: "queue.Queue" = queue.Queue()
        spans: Dict[str, Any] = {}

        def run(r: Replica, kind: str):
            t_dispatch = time.monotonic()
            span = None
            if trace is not None:
                span = trace.span(kind, replica=r.id)
                spans[r.id] = span
            try:
                out = self._tracked(r, path, body, headers)
                self._note(r, out[0], out[1], t_dispatch)
                if span is not None:
                    span.end(status=out[0])
            except _RETRYABLE_EXC as e:
                if isinstance(e, TimeoutError):
                    out = _timeout_response(self.timeout_s)
                else:
                    self.fleet.note_failure(r)
                    out = e
                if span is not None:
                    span.end(error=f"{type(e).__name__}: {e}")
            results.put((r, out))

        threading.Thread(target=run, args=(rep, "dispatch"),
                         daemon=True, name="fleet-primary").start()
        arms = 1
        hedged_to = None
        first = None
        try:
            first = results.get(timeout=self.hedge_after_ms / 1e3)
        except queue.Empty:
            h = self._pick(excluded | {rep.id})
            if h is not None and self._take_budget():
                self.metrics.inc("hedges")
                hedged_to = h
                threading.Thread(target=run, args=(h, "hedge"),
                                 daemon=True,
                                 name="fleet-hedge").start()
                arms += 1
        if first is None:
            first = results.get()
        r1, out1 = first
        winner = first
        if self._retryable(out1) and arms > 1:
            # first arrival failed retryably — the other arm may still
            # deliver; losing its answer would turn a hedge into a loss
            winner = results.get()
        rwin, out = winner
        if trace is not None and arms > 1:
            # mark the loser's span discarded (it may still be open —
            # the dump serializes open spans with a null duration)
            loser = rep if rwin is not rep else hedged_to
            lspan = spans.get(loser.id) if loser is not None else None
            if lspan is not None:
                lspan.attrs["discarded"] = True
        if self._retryable(out):
            excluded.add(r1.id)
            excluded.add(rwin.id)
            return out
        if rwin is not rep:
            self.metrics.inc("hedges_won")
        # the losing arm (if any) finishes in the background and its
        # response is discarded — that waste is exactly what the
        # budget bounds
        return out

    # -- streaming -----------------------------------------------------
    def open_stream(self, path: str, body: bytes, headers: Dict = None,
                    trace=None, session: Optional[str] = None):
        """Route a streaming generation: returns
        ``("stream", replica, conn, resp)`` with the response open
        (the caller MUST call ``conn.close()`` + ``replica.end()``
        when done — closing mid-stream is how a client disconnect
        propagates and frees the replica's slot/blocks), or
        ``("response", status, headers, data)`` for admission
        failures after retries."""
        self.metrics.inc("requests")
        excluded: Set[str] = set()
        last = None
        attempts = 0
        prefer = self._affinity_get(session)
        max_attempts = self.max_attempts or max(1, len(self.fleet.eligible()))
        while attempts < max_attempts:
            t_pick = time.perf_counter()
            rep = self._pick(excluded, prefer=prefer)
            if rep is None:
                break
            if trace is not None:
                trace.span("pick", t_start=t_pick,
                           t_end=time.perf_counter(), replica=rep.id,
                           attempt=attempts + 1, stream=True)
            attempts += 1
            if attempts > 1:
                self.metrics.inc("retries")
                if trace is not None:
                    trace.span("retry", attempt=attempts,
                               replica=rep.id).end()
            rep.begin()
            self.metrics.inc("routed")
            t_dispatch = time.monotonic()
            span = (trace.span("dispatch", replica=rep.id, stream=True)
                    if trace is not None else None)
            conn = http.client.HTTPConnection(rep.host, rep.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("POST", path, body=body,
                             headers=(_JSON_HEADERS if not headers
                                      else {**_JSON_HEADERS, **headers}))
                resp = conn.getresponse()
            except _RETRYABLE_EXC as e:
                conn.close()
                rep.end()
                if span is not None:
                    span.end(error=f"{type(e).__name__}: {e}")
                if isinstance(e, TimeoutError):
                    st, hdrs, data = _timeout_response(self.timeout_s)
                    self.metrics.inc("server_errors")
                    return ("response", st, hdrs, data)
                self.fleet.note_failure(rep)
                excluded.add(rep.id)
                last = None
                continue
            if span is not None:
                # for a stream the span covers dispatch -> first byte
                # of response headers, not the whole generation
                span.end(status=resp.status)
            if resp.status != 200:
                data = resp.read()
                conn.close()
                rep.end()
                hdrs = dict(resp.getheaders())
                self._note(rep, resp.status, hdrs, t_dispatch)
                if resp.status == 503:
                    excluded.add(rep.id)
                    last = (resp.status, hdrs, data)
                    continue
                if 400 <= resp.status < 500:
                    self.metrics.inc("client_errors")
                else:
                    self.metrics.inc("server_errors")
                return ("response", resp.status,
                        dict(resp.getheaders()), data)
            self.fleet.note_ok(rep, t_dispatch)
            self.metrics.inc("streams")
            self._affinity_note(session, rep.id)
            return ("stream", rep, conn, resp)
        self.metrics.inc("requests_lost")
        if last is not None:
            st, hdrs, data = last
            hdrs.setdefault("Retry-After", "1")
            return ("response", st, hdrs, data)
        return ("response", 503, {"Retry-After": "1"},
                json.dumps({"error": "no replica available"}).encode())

    def stream(self, path: str, payload):
        """Streamed generation through the fleet: yields parsed ndjson
        objects. ``close()`` on the generator (or abandoning it)
        closes the upstream connection, which frees the backing
        replica's slot/blocks exactly like a direct client
        disconnect."""
        session = None
        if isinstance(payload, dict):
            payload = dict(payload, stream=True)
            sid = payload.get("session_id")
            if isinstance(sid, str) and sid:
                session = sid
        opened = self.open_stream(path, json.dumps(payload).encode(),
                                  session=session)
        if opened[0] == "response":
            _, status, _hdrs, data = opened
            try:
                body = json.loads(data) if data else {}
            except ValueError:
                body = {}
            msg = (f"stream admission failed ({status}): "
                   f"{body.get('error', '?')}")
            raise NoReplicasError(msg) if status == 503 \
                else FleetError(msg)
        _, rep, conn, resp = opened
        return _FleetStream(rep, conn, resp)

    # -- observability -------------------------------------------------
    def stats(self) -> Dict:
        """Fleet counters + per-replica state/occupancy — the fleet
        analogue of a replica's ``GET /stats``."""
        return {"fleet": self.fleet.snapshot()}

    def _access_log(self, entry: Dict):
        """One structured JSON access-log line (see :meth:`serve`'s
        ``log_requests``). Logging failures never fail a request."""
        stream = self._log_stream
        if stream is None:
            return
        try:
            line = json.dumps(entry, separators=(",", ":"))
            with self._log_lock:
                stream.write(line + "\n")
                stream.flush()
        except (OSError, ValueError):
            pass

    def healthy(self) -> bool:
        """Router liveness: at least one admitted replica."""
        return any(r.admitted for r in self.fleet.replicas())

    def ready(self) -> bool:
        """Router readiness: at least one eligible replica."""
        return bool(self.fleet.eligible())

    # -- HTTP front-end ------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0,
              max_body_bytes: int = 256 * 1024 * 1024,
              log_requests=False, backend: str = "aio",
              header_timeout_s: float = 10.0):
        """Start the fleet's own HTTP listener (same route table as a
        replica, fleet-level probes/stats) and return (host, port).
        ``log_requests`` (off by default) enables a structured JSON
        access log — ``True`` logs to stderr, any file-like object
        logs there (same format as the replica's).

        ``backend="aio"`` (default) serves off one event loop with a
        NATIVELY async streaming proxy: an open proxied stream is two
        socket buffers and a coroutine, so connection count — the
        router's actual scaling axis — no longer breeds blocked
        threads, and upstream keep-alives ride an async checkout pool
        (docs/serving.md "Front-end architecture").
        ``backend="thread"`` is the original thread-per-connection
        listener. Routes and proxy semantics are identical."""
        router = self
        self._log_stream = (sys.stderr if log_requests is True
                            else (log_requests or None))
        if backend == "aio":
            from .aio import AioRouterFrontend
            self._aio = AioRouterFrontend(
                self, host, port, max_body_bytes=max_body_bytes,
                header_timeout_s=header_timeout_s)
            self.host = self._aio.host
            self.port = self._aio.port
            return self.host, self.port
        if backend != "thread":
            raise ValueError(f"unknown backend {backend!r} "
                             "(use 'aio' or 'thread')")

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def log_request(self, code="-", size="-"):
                # one line per response — see InferenceServer's
                # identically-shaped override
                if router._log_stream is None:
                    return
                try:
                    status = int(code)
                except (TypeError, ValueError):
                    status = str(code)
                t0 = getattr(self, "_t0", None)
                entry = {"ts": round(time.time(), 6),
                         "method": self.command,
                         "path": self.path,
                         "status": status,
                         "latency_ms": round(
                             (time.perf_counter() - t0) * 1e3, 3)
                         if t0 is not None else None,
                         "request_id": getattr(self, "_rid", None),
                         "priority": getattr(self, "_prio", None)}
                shed = getattr(self, "_shed", None)
                if shed is not None:
                    entry["shed_reason"] = shed
                router._access_log(entry)

            def _json(self, obj, code=200, headers=None):
                body = (obj if isinstance(obj, bytes)
                        else json.dumps(obj).encode())
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    rid = getattr(self, "_rid", None)
                    if rid:
                        self.send_header("X-Request-Id", rid)
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    # the client gave up (its own timeout) while the
                    # dispatch ran — routine, not a router error, and
                    # must not traceback-spam stderr per occurrence
                    self.close_connection = True

            def _text(self, body: str, code=200):
                data = body.encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "text/plain; "
                                     "version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    self.close_connection = True

            def do_GET(self):
                self._t0 = time.perf_counter()
                self._rid = self.headers.get("X-Request-Id")
                path, _, query = self.path.partition("?")
                try:
                    if path == "/stats":
                        self._json(router.stats())
                    elif path == "/metrics":
                        self._text(prometheus_text(router.stats()))
                    elif path == "/debug/traces":
                        q = parse_qs(query)
                        rid = (q.get("request_id") or q.get("id")
                               or [None])[0]
                        limit = int((q.get("limit") or [50])[0])
                        self._json({
                            "traces": router.tracer.dump(
                                request_id=rid, limit=limit),
                            "tracer": router.tracer.snapshot()})
                    elif path == "/healthz":
                        ok = router.healthy()
                        self._json({"status": "ok" if ok else
                                    "no replicas"}, 200 if ok else 503)
                    elif path == "/readyz":
                        if router.ready():
                            self._json({"ready": True})
                        else:
                            self._json({"ready": False,
                                        "reason": "no eligible replica"},
                                       503, headers={"Retry-After": "1"})
                    elif path in ("/v1/models", "/v1/models/"):
                        rep = router._pick(set())
                        if rep is None:
                            self._json({"error": "no replica available"},
                                       503, headers={"Retry-After": "1"})
                        else:
                            st, body = _get_json(
                                rep.host, rep.port, "/v1/models",
                                router.timeout_s)
                            self._json(body, st)
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:   # noqa: BLE001
                    self._json({"error": str(e)}, 500)

            def do_POST(self):
                self._t0 = time.perf_counter()
                # the front-end is where a request id is born (unless
                # the client brought one): the SAME id is forwarded to
                # whichever replicas this request touches, so the
                # router's spans and the winning replica's spans land
                # under one trace id
                self._rid = (self.headers.get("X-Request-Id")
                             or new_request_id())
                self._prio = self.headers.get("X-Priority")
                self._shed = None
                # same keep-alive body discipline as InferenceServer:
                # bad/oversized bodies must not desync or OOM
                if self.headers.get("Transfer-Encoding"):
                    self._json({"error": "Transfer-Encoding not "
                                "supported; send Content-Length"}, 501)
                    self.close_connection = True
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    n = -1
                if n < 0:
                    self._json({"error": "bad Content-Length"}, 400)
                    self.close_connection = True
                    return
                if n > max_body_bytes:
                    self._json({"error": "request body too large"}, 413)
                    self.close_connection = True
                    return
                raw = self.rfile.read(n)
                path, _, query = self.path.partition("?")
                # X-Priority carries the request's shed class — the
                # one client header with routing semantics; it must
                # survive the proxy hop or every fronted request
                # silently becomes interactive
                fwd = {"X-Request-Id": self._rid}
                prio = self.headers.get("X-Priority")
                if prio is not None:
                    fwd["X-Priority"] = prio
                # ?trace=1 on the QUERY (not the body — the router
                # must not pay a parse of predict bodies) forces a
                # trace even when the router tracer is off; the query
                # is NOT forwarded, so each tier opts in separately
                want_trace = bool(query
                                  and "trace=1" in query.split("&"))
                trace = router.tracer.begin(self._rid,
                                            force=want_trace)
                fspan = (trace.span("frontend", path=path)
                         if trace is not None else None)
                streaming = False
                session = None
                # only generate routes can stream — don't pay a json
                # parse of (possibly huge) predict bodies just to
                # sniff a flag they can't carry.  the same sniff pulls
                # session_id so the router can steer the turn to the
                # replica that pinned the session's KV blocks
                if path == "/generate" or \
                        path.rstrip("/").endswith("/generate"):
                    try:
                        req = json.loads(raw)
                        streaming = bool(isinstance(req, dict)
                                         and req.get("stream"))
                        if isinstance(req, dict):
                            sid = req.get("session_id")
                            if isinstance(sid, str) and sid:
                                session = sid
                    except ValueError:
                        pass   # replica answers 400; just forward
                if streaming:
                    self._proxy_stream(path, raw, fwd, trace, fspan,
                                       session=session)
                    return
                status, hdrs, data = router.post_raw(path, raw, fwd,
                                                     trace=trace,
                                                     session=session)
                if status in (503, 504):
                    self._shed = "overload"
                extra = {}
                if "Retry-After" in hdrs:
                    extra["Retry-After"] = hdrs["Retry-After"]
                if trace is not None:
                    fspan.end(status=status)
                    router.tracer.finish(trace, error=status >= 500)
                    if want_trace and status == 200:
                        # splice the router's spans into the replica's
                        # ?trace=1 timeline (or create one): the
                        # response carries the full cross-tier view
                        try:
                            body = json.loads(data)
                            if isinstance(body, dict):
                                body["router_trace"] = trace.to_dict()
                                data = json.dumps(body).encode()
                        except ValueError:
                            pass
                self._json(data, status, headers=extra)

            def _proxy_stream(self, path: str, raw: bytes,
                              fwd: Dict = None, trace=None,
                              fspan=None, session=None):
                opened = router.open_stream(path, raw, fwd,
                                            trace=trace,
                                            session=session)
                if trace is not None:
                    fspan.end(status=(opened[1]
                                      if opened[0] == "response"
                                      else 200), stream=True)
                    router.tracer.finish(
                        trace, error=(opened[0] == "response"
                                      and opened[1] >= 500))
                if opened[0] == "response":
                    _, status, hdrs, data = opened
                    extra = {}
                    if "Retry-After" in hdrs:
                        extra["Retry-After"] = hdrs["Retry-After"]
                    self._json(data, status, headers=extra)
                    return
                _, rep, conn, resp = opened
                try:
                    try:
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                    except OSError:
                        self.close_connection = True
                        return
                    # upstream READ and downstream WRITE failures are
                    # different events and must not be conflated: a
                    # dying replica (IncompleteRead — an HTTPException,
                    # NOT an OSError — or a read timeout) leaves a LIVE
                    # client that is owed the same in-band error chunk
                    # the replica-direct path delivers; a vanished
                    # client just needs the upstream closed (which
                    # aborts the generation and frees its slot/blocks)
                    err = None
                    while True:
                        try:
                            line = resp.readline()
                        except _RETRYABLE_EXC as e:
                            err = {"error": "replica stream failed: "
                                            f"{type(e).__name__}: {e}",
                                   "status": 500, "done": True}
                            break
                        if not line:
                            break
                        if not line.strip():
                            continue
                        try:
                            self.wfile.write(
                                f"{len(line):X}\r\n".encode()
                                + line + b"\r\n")
                            self.wfile.flush()
                        except OSError:
                            # downstream client vanished mid-stream
                            self.close_connection = True
                            return
                    try:
                        if err is not None:
                            data = (json.dumps(err) + "\n").encode()
                            self.wfile.write(
                                f"{len(data):X}\r\n".encode()
                                + data + b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        self.close_connection = True
                finally:
                    conn.close()
                    rep.end()

        self.httpd = _Server((host, port), Handler)
        self.host = self.httpd.server_address[0]
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="fleet-http")
        self._http_thread.start()
        return self.host, self.port

    def stop(self):
        """Stop the router's HTTP listener (if started) and drop
        pooled connections. Replicas and the fleet poll loop are
        owned by :class:`ReplicaFleet` — stop them there."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self._aio is not None:
            self._aio.stop()
            self._aio = None
        self._pool.close_all()
