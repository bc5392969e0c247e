"""The elastic-training control plane of multi-process training
(counterpart of the framework-free part of
``deeplearning4j_tpu/parallel/multihost.py``, lifted line for line):

- :class:`PreemptionCoordinator`: a small coordination channel that
  turns ONE worker's preemption notice (SIGTERM or an injected
  :class:`~..faults.PreemptionFault`) into a fleet-wide step-boundary
  checkpoint flush. In-process it is a monotonic generation token every
  registered trainer polls at its step boundaries; with a
  ``channel_dir`` (normally the shared checkpoint directory) the token
  also rides a sentinel file, so worker processes on a shared
  filesystem coordinate the same way, with no sockets and no extra
  service.
- :func:`split_data_cursor`: per-worker views of a checkpoint's global
  data cursor for resuming fleets.

The global-array helpers (``global_mesh``, ``host_local_array``,
``replicated_array``, ``MultiHostIterator``, ``build_multihost_step``)
need a cross-process device set and come with ``ParallelWrapper``
(ROADMAP.md queue A, item 14).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


class PreemptionCoordinator:
    """Fleet-wide preemption broadcast (see module docstring).

    Semantics are generation-based, not edge-based: ``signal()`` bumps
    a monotonic token; a trainer records the token at ``fit()`` entry
    and treats any LARGER token observed at a step boundary as "the
    fleet is being preempted — flush now". Notices that predate a fit
    are therefore ignored (a restarted fleet does not re-preempt itself
    off last run's sentinel), and duplicate signals coalesce for free.

    With ``channel_dir`` the token is mirrored into
    ``<channel_dir>/PREEMPT.signal`` via the atomic temp+rename
    discipline, so worker processes sharing a filesystem (the normal
    sharded-checkpoint layout) see each other's notices within one step
    boundary. The lock is re-entrant because ``signal()`` may be
    reached from a signal handler interrupting a thread that is inside
    ``generation()``."""

    SENTINEL = "PREEMPT.signal"

    def __init__(self, channel_dir: Optional[str] = None):
        self.channel_dir = channel_dir
        self._lock = threading.RLock()
        self._gen = 0.0
        self._last_source = None
        self._seen_mtime_ns = -1   # sentinel parse guard (see below)
        if channel_dir:
            os.makedirs(channel_dir, exist_ok=True)

    def _sentinel_path(self) -> Optional[str]:
        return (os.path.join(self.channel_dir, self.SENTINEL)
                if self.channel_dir else None)

    def signal(self, source=None) -> float:
        """Broadcast a preemption notice; returns the new token."""
        # absorb any newer sentinel first: a fresh coordinator (operator
        # shell, restarted process) starts at _gen=0, and computing the
        # token from local state alone could commit a LOWER token than
        # the one already on disk — overwriting it and silently losing
        # the notice for every worker whose gen0 came from the file
        self.generation()
        with self._lock:
            token = max(time.time(), self._gen + 1e-6)
            self._gen = token
            self._last_source = source
            path = self._sentinel_path()
            if path is not None:
                tmp = f"{path}.tmp.{os.getpid()}"
                try:
                    with open(tmp, "w") as f:
                        json.dump({"token": token,
                                   "source": source,
                                   "pid": os.getpid()}, f)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)
                except OSError:
                    # a dying disk must not turn the local notice into
                    # a crash — in-process members still observe it
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            return token

    def generation(self) -> float:
        """Current token: max of the in-process value and the sentinel
        file's (cross-process notices). Called once per step boundary
        by every trainer, so the sentinel is only re-PARSED when its
        mtime advanced — the common case (no notice) costs one stat."""
        with self._lock:
            gen = self._gen
            path = self._sentinel_path()
            seen = self._seen_mtime_ns
        if path is not None:
            try:
                mtime_ns = os.stat(path).st_mtime_ns
                if mtime_ns != seen:
                    with open(path) as f:
                        data = json.load(f)
                    file_tok = float(data.get("token", 0.0))
                    with self._lock:
                        self._seen_mtime_ns = mtime_ns
                        if file_tok > self._gen:
                            self._gen = file_tok
                            self._last_source = data.get("source")
                    gen = max(gen, file_tok)
            except (OSError, ValueError):
                pass   # missing/mid-replace sentinel = no notice
        return gen

    @property
    def last_source(self):
        """Who signalled last (worker id / signal number), best-effort
        — for logs and tests, not for control flow."""
        self.generation()    # absorb a newer sentinel first
        with self._lock:
            return self._last_source

    def reset(self):
        """Clear the channel (tests / an operator acknowledging the
        notice). Running fits are unaffected either way — they compare
        against the token captured at their own start."""
        with self._lock:
            self._gen = 0.0
            self._last_source = None
            self._seen_mtime_ns = -1
            path = self._sentinel_path()
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass


def split_data_cursor(cursor: Optional[dict], num_workers: int
                      ) -> List[Optional[dict]]:
    """Per-worker views of a checkpoint's GLOBAL data cursor.

    The cursor is stored in global terms on purpose — optimizer steps
    and global batches consumed, plus the iterator's replay state — so
    it is valid for ANY fleet shape: every shape consumes the same
    global batch sequence, and a worker's slice of each global batch is
    derived from (worker, num_workers) at step-build time, not baked
    into the checkpoint. Splitting therefore annotates rather than
    divides: each worker resumes at the same global position with its
    own ``worker``/``num_workers`` coordinates attached (consumed by
    per-process input pipelines to re-derive their rows after a
    re-mesh)."""
    w = int(num_workers)
    if w < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if cursor is None:
        return [None] * w
    return [dict(cursor, worker=i, num_workers=w) for i in range(w)]
