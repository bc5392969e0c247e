"""Multi-process training helpers (counterpart of
``deeplearning4j_tpu/parallel/multihost.py``).

After ``elastic.initialize_cluster(...)`` every process is a rank of one
``torch.distributed`` world. :func:`global_mesh` is a mesh over all the
ranks; a rank holds its own rows of a global batch as a
:class:`~..nn.global_batch.LocalShard` (:func:`host_local_array`: the
multi-process input pipeline, each process loading only its rows), and
a replicated value is simply every rank's own copy
(:func:`replicated_array`). :func:`build_multihost_step` is the dense
data-parallel step over such a mesh and :class:`MultiHostIterator`
turns a per-process iterator into one of local shards;
``ParallelWrapper.fit`` applies it when there are several processes.

The elastic-training control plane, lifted line for line from the JAX
module (it needs no framework):

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
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets import DataSetIterator as _DataSetIterator
from ..nn.global_batch import LocalShard
from . import Mesh, PartitionSpec as P
from .transport import world_size


def global_mesh(axis: str = "data") -> Mesh:
    """A 1-D mesh over every rank (call after ``initialize_cluster``;
    every process builds it the same way: it creates process groups)."""
    return Mesh(np.arange(world_size()), (axis,))


def host_local_array(mesh: Mesh, spec: Sequence, local,
                     global_shape: Optional[Tuple[int, ...]] = None
                     ) -> LocalShard:
    """This rank's rows of a global array sharded over ``spec``'s one
    axis (which must be the first): ``local`` plus the global shape, the
    first axis scaled by the mesh's size along the spec's mesh axis
    unless ``global_shape`` is given."""
    sharded = [i for i, a in enumerate(spec) if a is not None]
    if sharded != [0]:
        raise ValueError(
            f"spec {tuple(spec)}: a rank's shard is its rows, so exactly "
            "the first axis is sharded")
    local = torch.as_tensor(np.asarray(local)) \
        if not isinstance(local, torch.Tensor) else local
    if global_shape is None:
        global_shape = (local.shape[0] * mesh.shape[spec[0]],) + \
            tuple(local.shape[1:])
    return LocalShard(local, global_shape)


def replicated_array(mesh: Mesh, value):
    """A value (a tensor, an array or a tree of them: params, updater
    state) replicated over the mesh: every rank holds its own whole
    copy, so this is the value itself, arrays as tensors."""
    if isinstance(value, dict):
        return {k: replicated_array(mesh, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(replicated_array(mesh, v) for v in value)
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value)
    return value


class MultiHostIterator(_DataSetIterator):
    """A per-process ``DataSetIterator`` for multi-process training:
    each process's iterator yields ITS rows of every global batch (every
    process loads different rows) and this wrapper marks them as local
    shards of the global arrays the step consumes. All processes step
    their iterators in lockstep (the same number of batches an epoch).
    ``ParallelWrapper.fit`` applies it when there are several
    processes."""

    def __init__(self, base, mesh: Mesh, axis: str = "data"):
        self.base = base
        self.mesh = mesh
        self.axis = axis

    def _to_global(self, arr):
        return host_local_array(self.mesh, P(self.axis), arr)

    def has_next(self):
        return self.base.has_next()

    def next(self):
        b = self.base.next()
        if not isinstance(b, (tuple, list)):
            b = (b.features, b.labels, getattr(b, "labels_mask", None))
        return tuple(self._to_global(v) if v is not None else None
                     for v in b)

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size() * self.mesh.shape[self.axis]

    def state_dict(self):
        return self.base.state_dict() if hasattr(self.base,
                                                 "state_dict") else None

    def load_state_dict(self, state):
        if hasattr(self.base, "load_state_dict"):
            self.base.load_state_dict(state)


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


def build_multihost_step(model, mesh: Mesh, axis: str = "data"):
    """The model's dense data-parallel step over a multi-process mesh
    (the multi-process ``ParallelWrapper`` step): every rank calls it
    with its shard of the batch (:func:`host_local_array`) or the whole
    global batch, and the same replicated state. The contract is
    ``parallel.jit_sharded_step``'s."""
    from . import jit_sharded_step
    return jit_sharded_step(model, mesh, axis)
