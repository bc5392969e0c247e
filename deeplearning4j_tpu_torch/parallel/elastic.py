"""Fault tolerance: preemption-safe checkpoint/restart training
(counterpart of ``deeplearning4j_tpu/parallel/elastic.py``).

:class:`FaultTolerantTrainer` trains with periodic whole-state
checkpoints through the port's ``util/serializer.py`` (the JAX
package's zip format v2, or v3 shard directories under a manifest
committed last), written atomically (a pid-unique temp in the
checkpoint directory, fsync, rename, directory fsync), pruned to
``keep_last`` and with crashed writers' temps swept by pid liveness;
``resume`` restores the newest completed one.

Any of ``save_every_n_steps``, ``fault_injector`` or ``anomaly_guard``
switches :meth:`~FaultTolerantTrainer.fit` to the supervised step loop
(:mod:`.resilience`): step-granular asynchronous checkpoints that hold
everything a bit-exact resume needs (counters, the key chain, the data
iterator's replay cursor), retries of transient faults at the
``train_step``, ``data_batch`` and ``checkpoint_io`` seams, the
anomaly-guarded step with skip-and-count and rollback after K, and
step-granular preemption: an injected ``preempt`` fault, a SIGTERM seen
by :class:`PreemptionHandler`, or another worker's notice through a
:class:`~.multihost.PreemptionCoordinator` flushes a checkpoint at the
next step boundary and raises :class:`~..faults.PreemptionFault`.

With ``wrapper=`` (a ``ParallelWrapper``) the loop runs the wrapper's
data-parallel step, dense or compressed, and the gradient-sharing
state (every worker's residual and updater moments, the threshold)
rides in every checkpoint: gathered from the ranks into JAX's stacked
``gradient_sharing/...`` members, so each package restores the other's
archives. Sharded (v3) checkpoints then hold one shard a worker. A
resume at the same worker count is bit for bit; at another count the
resuming wrapper re-buckets the per-worker arrays
(``parallel.rebucket_worker_array``) and records ``last_remesh``. With
several ranks, every rank runs the same trainer on the same data: the
snapshots are collectives, only the mesh's first rank writes, and the
step-boundary preemption decisions are agreed over the ranks, so all
stop at the same step.

:func:`initialize_cluster` joins this process to a
``torch.distributed`` world.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .. import random as R
from ..faults import (FaultInjector, PreemptionFault,  # noqa: F401
                      TransientFault)
from ..tracing import new_request_id
from ..util.serializer import (MANIFEST_NAME, CheckpointFormatError,  # noqa: F401
                               ModelSerializer, shard_name,
                               shard_training_snapshot,
                               snapshot_training_state, write_shard)
from .multihost import PreemptionCoordinator, split_data_cursor  # noqa: F401
from .resilience import (AsyncCheckpointWriter, TrainingAnomalyError,  # noqa: F401
                         TrainingSupervisor)


def _pid_alive(pid: int) -> bool:
    """Is some process with this pid running? (EPERM means yes —
    a live process we may not signal.)"""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


#: completed-checkpoint filename filter AND sort key. Matches the
#: epoch-boundary form (`checkpoint_epoch3.zip` = 3 epochs done), the
#: step-granular form (`checkpoint_epoch3_step120.zip` = mid
#: epoch-index 3, 120 optimizer steps done), and the format-v3 SHARD
#: DIRECTORY forms of both (`checkpoint_epoch3_step120.ckpt/`).
#: Sorting by (epoch, step) is chronological: a mid-epoch-3 checkpoint
#: (3, S) sits after the epoch-3 boundary (3, 0) and before the
#: epoch-4 boundary (4, 0) — regardless of format.
_CKPT_RE = re.compile(r"checkpoint_epoch(\d+)(?:_step(\d+))?\.(?:zip|ckpt)$")


class FaultTolerantTrainer:
    """Train with periodic whole-state checkpoints; resume picks up at
    the last completed checkpoint.

    Epoch mode (default, the original surface)::

        FaultTolerantTrainer(model, ckpt_dir).fit(it, epochs=100)

    Resilient step mode — any of ``save_every_n_steps``,
    ``fault_injector`` or ``anomaly_guard`` switches :meth:`fit` to
    the supervised step loop::

        inj = FaultInjector(rates={"train_step": 0.01})
        tr = FaultTolerantTrainer(model, ckpt_dir,
                                  save_every_n_steps=50,
                                  fault_injector=inj,
                                  anomaly_guard=True)
        try:
            tr.fit(it, epochs=100)
        except PreemptionFault:
            pass            # restart: resume() + fit() continues
                            # bit-exactly mid-epoch

    Pass ``wrapper=ParallelWrapper(model, ...)`` to run the supervised
    loop over the wrapper's data-parallel (optionally compressed) step;
    the gradient-sharing accumulator's residuals, threshold and
    per-worker updater moments ride inside every checkpoint and restore
    on resume."""

    def __init__(self, model, checkpoint_dir: str,
                 save_every_n_epochs: int = 1, keep_last: int = 3,
                 save_every_n_steps: Optional[int] = None,
                 async_write: bool = True,
                 fault_injector: Optional[FaultInjector] = None,
                 max_step_retries: int = 3,
                 retry_backoff_ms: float = 5.0,
                 anomaly_guard: bool = False,
                 rollback_after: int = 3,
                 snapshot_every_n_steps: Optional[int] = None,
                 wrapper=None,
                 sharded_checkpoints: bool = False,
                 coordinator: Optional[PreemptionCoordinator] = None,
                 worker_id: Optional[int] = None,
                 tracer=None,
                 events=None,
                 fleet_telemetry=None):
        self.model = model
        self.dir = checkpoint_dir
        self.save_every = max(1, save_every_n_epochs)
        self.keep_last = keep_last
        self.save_every_n_steps = (None if not save_every_n_steps
                                   else max(1, int(save_every_n_steps)))
        self.async_write = bool(async_write)
        self.injector = fault_injector
        self.sharded_checkpoints = bool(sharded_checkpoints)
        self.coordinator = coordinator
        self.worker_id = (None if worker_id is None else int(worker_id))
        self.wrapper = wrapper
        if wrapper is not None and wrapper.model is not model:
            raise ValueError("wrapper.model must be the trainer's model")
        # with several ranks only the mesh's first writes the archives;
        # the others take part in each snapshot's gathers
        self._writes = wrapper is None or wrapper.writes_checkpoints
        self._ranks = 1 if wrapper is None else wrapper.mesh.size
        self._step_mode = bool(self.save_every_n_steps
                               or fault_injector is not None
                               or anomaly_guard)
        self.supervisor = TrainingSupervisor(
            fault_injector=fault_injector,
            max_step_retries=max_step_retries,
            retry_backoff_ms=retry_backoff_ms,
            anomaly_guard=anomaly_guard,
            rollback_after=rollback_after)
        # observability plane (all optional; see docs/observability.md).
        # The hot loop never calls into the tracer: when a trace is
        # live, phase timings ride an append-only ring of (kind, t0,
        # t1, attrs) tuples and spans are rebuilt retroactively at fit
        # exit — with no tracer the ring is None and the loop carries
        # only a dead None-check
        self.tracer = tracer
        self.events = events
        self.fleet = fleet_telemetry
        self.supervisor.events = events
        self.supervisor.fleet = fleet_telemetry
        self.supervisor.worker = self.worker_id
        self._obs = None
        self._trace = None
        self._root_span = None
        self._remesh_reported = False
        self._phases = {"data_wait_s": 0.0, "device_step_s": 0.0}
        # rollback-snapshot cadence: default to the disk cadence (the
        # same host copy feeds both); a guarded run with no disk
        # cadence still needs a rollback source, so it snapshots every
        # good step — but an injector-only run (no guard, no disk
        # cadence) has NO consumer for the copy, so it takes none: a
        # device→host copy of the full state per step is not "zero
        # overhead when no anomaly can ever fire"
        self.snapshot_every_n_steps = (
            max(1, int(snapshot_every_n_steps))
            if snapshot_every_n_steps
            else (self.save_every_n_steps or (1 if anomaly_guard
                                              else None)))
        self._writer: Optional[AsyncCheckpointWriter] = None
        self._step_fns = {}
        # preemption coordination (PreemptionHandler + preempt seam)
        self._coord_gen0: Optional[float] = None
        self._loop_active = False
        self._preempt_requested = threading.Event()
        self._preempt_handler = None
        self._preempt_signum = None
        self._batches_done = 0
        self._epoch_it_state = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    # -- checkpoint management -----------------------------------------
    @property
    def _ext(self) -> str:
        return "ckpt" if self.sharded_checkpoints else "zip"

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.dir,
                            f"checkpoint_epoch{epoch}.{self._ext}")

    def _step_ckpt_path(self, epoch: int, step: int) -> str:
        return os.path.join(
            self.dir, f"checkpoint_epoch{epoch}_step{step}.{self._ext}")

    def _num_shards(self) -> int:
        """v3 shard count: the wrapper's worker count (the per-worker
        state's leading axis), 1 for a plain single-worker trainer."""
        return (self.wrapper.num_workers if self.wrapper is not None
                else 1)

    @staticmethod
    def list_checkpoints(directory: str) -> List[str]:
        """Completed checkpoints only, oldest -> newest — v2 zips and
        v3 shard directories interleaved chronologically. The regex is
        a FULL filename filter, not just a sort key: temp files/dirs
        from an interrupted write (``*.tmp.<pid>``) and any stray file
        must never be listed — resume() loads the last entry, and
        keep-last pruning deletes the first ones. A ``.ckpt`` directory
        additionally needs its ``manifest.json`` — the writer commits
        the manifest last, so its absence means a torn multi-shard
        write that must never be surfaced as resumable."""
        paths = []
        for p in glob.glob(os.path.join(directory, "checkpoint_epoch*")):
            if not _CKPT_RE.search(p):
                continue
            if p.endswith(".ckpt") and not (
                    os.path.isdir(p)
                    and os.path.isfile(os.path.join(p, MANIFEST_NAME))):
                continue
            paths.append(p)

        def key(p):
            m = _CKPT_RE.search(p)
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                mtime = 0.0
            # mtime tiebreaks a same-(epoch, step) opposite-format twin
            # pair: the writer removes its stale twin, but a crash in
            # that window (or an EPERM on the remove) can leave both —
            # the NEWER write must win deterministically, not glob order
            return (int(m.group(1)), int(m.group(2) or 0), mtime)
        return sorted(paths, key=key)

    def _write_atomic(self, snap: dict, path: str):
        """One durable checkpoint write: pid-unique temp IN the
        checkpoint directory, data fsync, atomic rename, directory
        fsync, then rotation + stale-temp sweep. Fires the
        ``checkpoint_io`` seam (bounded retry on transient fires — a
        failed write attempt never touches the live checkpoint, the
        temp machinery guarantees that; a failed SHARDED attempt is
        restarted whole, its temp dir discarded). Runs on the async
        writer thread in step mode, inline otherwise; a no-op on a rank
        that does not write."""
        if not self._writes:
            return
        t0 = time.perf_counter()
        sup = self.supervisor
        attempt = 0
        while True:
            try:
                if self.sharded_checkpoints:
                    # the seam fires INSIDE, once per shard (worker-
                    # scoped) + once before the manifest commit — the
                    # torn-write crash windows tests script against
                    self._write_sharded_once(snap, path)
                else:
                    if self.injector is not None:
                        self.injector.fire("checkpoint_io")
                    self._write_once(snap, path)
                break
            except TransientFault:
                sup.retries.inc()
                if attempt >= sup.max_step_retries:
                    raise
                # the same retry knobs the step seams honor
                # (max_step_retries / retry_backoff_ms)
                time.sleep(sup.retry_backoff_ms * (2 ** attempt) / 1e3)
                attempt += 1
        if self.sharded_checkpoints:
            sup.sharded_checkpoints.inc()
        self._prune_and_sweep()
        dur = time.perf_counter() - t0
        # single-writer by construction (the async worker, or the loop
        # thread after _writer.wait()), so += cannot lose increments
        self.supervisor.checkpoint_write_s += dur
        obs = self._obs     # deque.append is thread-safe from the
        if obs is not None:  # async writer thread
            obs.append(("checkpoint_write", t0, t0 + dur,
                        {"path": os.path.basename(path)}))
        if self.events is not None:
            self.events.record("checkpoint_commit",
                               worker=self.worker_id,
                               path=os.path.basename(path),
                               duration_ms=round(dur * 1e3, 3),
                               bytes=self._ckpt_bytes(path))

    @staticmethod
    def _ckpt_bytes(path: str) -> int:
        """On-disk size of a committed checkpoint (sum of files for a
        v3 shard directory)."""
        try:
            if os.path.isdir(path):
                return sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(path) for f in fs)
            return os.path.getsize(path)
        except OSError:
            return 0

    def _write_once(self, snap: dict, path: str):
        # pid-unique temp name IN the checkpoint directory (rename
        # must not cross filesystems): a crash mid-write leaves
        # only a temp file resume() will never look at, and a
        # restarted writer can't collide with the corpse
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            ModelSerializer.write_snapshot(snap, tmp)
            # flush the bytes to stable storage BEFORE the rename
            # goes live — os.replace alone is atomic against
            # process crashes but can surface a truncated target
            # after a power loss reorders the metadata ahead of
            # the data
            with open(tmp, "rb+") as f:
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic: partials never go live
            # ...and make the rename itself durable: the directory
            # entry is still only in the page cache, and for a NEW
            # checkpoint name a power loss could lose the file
            # entirely despite the write having returned success
            self._fsync_dir(self.dir)
            # remove a stale opposite-format twin (same (epoch, step)
            # sort key — it could shadow this write at resume)
            twin = path[:-len(".zip")] + ".ckpt"
            if os.path.isdir(twin):
                shutil.rmtree(twin, ignore_errors=True)
        except BaseException:
            # never leave a half-written temp behind on failure
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _fsync_dir(self, d: str):
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _write_sharded_once(self, snap: dict, path: str):
        """One format-v3 write attempt: a pid-unique TEMP DIRECTORY in
        the checkpoint dir, each shard written via its own inner temp +
        fsync + rename, the manifest committed LAST (also temp+rename),
        the temp dir fsynced, and finally the whole directory renamed
        to the live name + parent fsync. Kill the process between ANY
        two of those operations and ``list_checkpoints`` sees either
        the previous checkpoint or nothing: a ``*.tmp.<pid>`` dir is
        never listed, and a directory without a manifest is rejected
        even if it somehow lands at the live name."""
        shards, manifest = shard_training_snapshot(snap,
                                                   self._num_shards())
        pid = os.getpid()
        tmp_dir = f"{path}.tmp.{pid}"
        try:
            os.makedirs(tmp_dir, exist_ok=True)
            for i, shard in enumerate(shards):
                if self.injector is not None:
                    # worker-scoped: "crash between shard i-1 and i"
                    # is scriptable per worker
                    self.injector.fire("checkpoint_io", worker=i)
                fname = shard_name(i)
                tmp = os.path.join(tmp_dir, f"{fname}.tmp.{pid}")
                write_shard(shard, tmp)
                with open(tmp, "rb+") as f:
                    os.fsync(f.fileno())
                final = os.path.join(tmp_dir, fname)
                os.replace(tmp, final)
                manifest["shards"][i]["bytes"] = os.path.getsize(final)
                manifest["shards"][i]["entries"] = {
                    s: len(shard[s]) for s in
                    ("params", "net_state", "opt_state", "extra")}
            if self.injector is not None:
                # the last-shard -> manifest-commit window
                self.injector.fire("checkpoint_io")
            mtmp = os.path.join(tmp_dir, f"{MANIFEST_NAME}.tmp.{pid}")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(tmp_dir, MANIFEST_NAME))
            self._fsync_dir(tmp_dir)
            doomed = None
            if os.path.exists(path):
                # re-writing an existing checkpoint name (re-run of a
                # completed schedule): dirs cannot be replaced
                # atomically, so step the old one ASIDE (one cheap
                # rename) rather than rmtree-ing it first — a kill in
                # the rename/rename window leaves a complete committed
                # checkpoint at the .old name, and the sweep renames it
                # BACK if the live name never landed (a keep_last=1 run
                # must never lose its only checkpoint to this window)
                doomed = f"{path}.old.{os.getpid()}"
                os.rename(path, doomed)
            try:
                os.rename(tmp_dir, path)
            except BaseException:
                if doomed is not None:
                    os.rename(doomed, path)   # un-step the old one
                raise
            self._fsync_dir(self.dir)
            if doomed is not None:
                shutil.rmtree(doomed, ignore_errors=True)
            # a now-stale opposite-FORMAT twin (checkpoint_epochE.zip
            # next to this .ckpt) would sort as the same (epoch, step)
            # key and could shadow this write at resume — remove it
            twin = path[:-len(".ckpt")] + ".zip"
            if os.path.exists(twin):
                try:
                    os.remove(twin)
                except OSError:
                    pass
        except BaseException:
            # never leave this attempt's partial shard dir behind on an
            # in-process failure; a process CRASH leaves it for the
            # stale-temp sweep (dead-pid rule)
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise

    @staticmethod
    def _temp_pid_alive(path: str) -> bool:
        pid_s = path.rsplit(".", 1)[-1]
        return pid_s.isdigit() and _pid_alive(int(pid_s))

    def _prune_and_sweep(self):
        ckpts = self.list_checkpoints(self.dir)
        for old in ckpts[:-self.keep_last] if self.keep_last else []:
            try:
                if os.path.isdir(old):
                    shutil.rmtree(old)
                else:
                    os.remove(old)
            except OSError:
                pass  # a concurrent writer's rotation got there first
        # sweep temp corpses from CRASHED earlier runs (ours was
        # renamed or removed above); they'd otherwise pin disk
        # forever since list_checkpoints rightly skips them. A temp
        # whose embedded pid is still ALIVE is not a corpse — it's
        # a concurrent trainer (preemption handover: the dying
        # process's final write overlapping our first) mid-write,
        # and deleting it would destroy that checkpoint
        for stale in glob.glob(os.path.join(
                self.dir, "checkpoint_epoch*.zip.tmp.*")):
            if self._temp_pid_alive(stale):
                continue
            try:
                os.remove(stale)
            except OSError:
                pass
        # same rule for SHARDED temps: a dead writer's partial shard
        # DIRECTORY (and everything in it — completed shards, inner
        # shard temps, an uncommitted manifest) goes; a live concurrent
        # writer's is spared wholesale — its inner temps belong to that
        # live pid by construction (the dir name and the inner temp
        # names embed the same writer pid)
        for stale in glob.glob(os.path.join(
                self.dir, "checkpoint_epoch*.ckpt.tmp.*")):
            if self._temp_pid_alive(stale):
                continue
            shutil.rmtree(stale, ignore_errors=True)
        # a dead writer's stepped-aside old checkpoint (`*.ckpt.old.
        # <pid>` — see _write_sharded_once's rewrite path): if the live
        # name never landed, the .old dir is the ONLY copy of that
        # checkpoint — rename it back instead of sweeping it
        for stale in glob.glob(os.path.join(
                self.dir, "checkpoint_epoch*.ckpt.old.*")):
            if self._temp_pid_alive(stale):
                continue
            base = stale.rsplit(".old.", 1)[0]
            try:
                if os.path.exists(base):
                    shutil.rmtree(stale, ignore_errors=True)
                else:
                    os.rename(stale, base)
            except OSError:
                pass
        # and orphaned per-shard temps inside COMMITTED directories
        # (manually repaired / rsynced layouts; a normal commit renames
        # every inner temp before the manifest lands)
        for stale in glob.glob(os.path.join(
                self.dir, "checkpoint_epoch*.ckpt", "*.tmp.*")):
            if self._temp_pid_alive(stale):
                continue
            try:
                os.remove(stale)
            except OSError:
                pass

    def _save(self, epoch: int, cursor: Optional[dict] = None):
        # _saving guards signal-handler re-entry: a SIGTERM landing
        # mid-write must not start a second write (see
        # PreemptionHandler._handle)
        self._saving = True
        try:
            snap = snapshot_training_state(self.model, cursor=cursor,
                                           extra=self._extra_state())
            self._write_atomic(snap, self._ckpt_path(epoch))
        finally:
            self._saving = False

    def _extra_state(self):
        """The wrapper's gathered gradient-sharing state (a collective
        on every rank), or None."""
        if self.wrapper is not None:
            return self.wrapper.extra_checkpoint_state()
        return None

    # -- training ------------------------------------------------------
    def fit(self, iterator, epochs: int):
        """Train up to a TOTAL of `epochs` epochs (counting the model's
        current epoch counter), checkpointing every `save_every` epochs
        (plus every `save_every_n_steps` optimizer steps in step mode).
        After a preemption, `resume()` + `fit()` with the same total
        continues where the last checkpoint left off — bit-exactly in
        step mode; if the target was already reached, this is a no-op."""
        if self._step_mode:
            return self._fit_supervised(iterator, epochs)
        start = self.model._epoch
        for e in range(start, epochs):
            if self.wrapper is not None:
                self.wrapper.fit(iterator, epochs=1)
            else:
                self.model.fit(iterator, epochs=1)  # fit() advances _epoch
            if (e + 1) % self.save_every == 0 or e + 1 == epochs:
                self._save(e + 1)
        self._ranks_meet()
        return self.model

    def _ranks_meet(self):
        """With several ranks, every rank waits here for the others (the
        writer's archives are committed by then), so a rank that resumes
        right after its fit finds them."""
        if self._ranks > 1:
            self.wrapper.agree_any([False])

    # -- the supervised step loop --------------------------------------
    def _ensure_step(self) -> Callable:
        """The step for this trainer's config: the model's pure step
        (``_make_step_fn``) or the wrapper's data-parallel one, guarded
        when the anomaly guard is on; built once and cached."""
        guard = self.supervisor.anomaly_guard
        if self.wrapper is not None:
            step = self.wrapper.ensure_step(guard=guard)
            self.supervisor.extra_state_fn = \
                self.wrapper.extra_checkpoint_state
            self.supervisor.load_extra_fn = \
                self.wrapper.load_extra_checkpoint_state
            return step
        key = "guard" if guard else "plain"
        if key not in self._step_fns:
            self._step_fns[key] = self.model._make_step_fn(guard=guard)
        return self._step_fns[key]

    def _current_cursor(self) -> dict:
        return {"epoch": self.model._epoch,
                "batches_into_epoch": self._batches_done,
                "iterator": self._epoch_it_state}

    # -- observability (zero-cost-when-disabled) -----------------------
    def _begin_observed(self, cursor: Optional[dict], t_fit0: float):
        """Open a per-fit trace (if a tracer is attached and enabled)
        and arm the retro-span ring. The step loop itself never calls
        the tracer: it appends plain (kind, t0, t1, attrs) tuples to
        ``self._obs`` — None when no trace is live, so a disabled run's
        loop carries only a dead None-check — and
        :meth:`_finish_observed` rebuilds real spans from the ring at
        fit exit. A resume and a re-mesh are recorded up front; events
        go to the timeline even when no tracer is attached."""
        self._phases = {"data_wait_s": 0.0, "device_step_s": 0.0}
        self.model._phase_breakdown = self._phases
        rm = (getattr(self.wrapper, "last_remesh", None)
              if self.wrapper is not None else None)
        if rm is not None and self._remesh_reported:
            rm = None
        if self.events is not None:
            if cursor is not None:
                self.events.record(
                    "resume", worker=self.worker_id,
                    epoch=int(cursor.get("epoch") or 0),
                    step=int(self.model._step))
            if rm is not None:
                self.events.record("re_mesh", worker=self.worker_id,
                                   from_workers=rm[0], to_workers=rm[1])
        trc = self.tracer
        self._trace = None
        self._obs = None
        self.supervisor.obs = None
        if trc is None:
            return
        if not trc.enabled:         # disabled: stay zero-cost — don't
            if rm is not None:      # even mint a request id
                self._remesh_reported = True
            return
        wid = (self.worker_id if self.worker_id is not None
               else os.getpid())
        t = trc.begin(request_id=f"train-w{wid}-{new_request_id()}")
        if t is None:
            if rm is not None:
                self._remesh_reported = True
            return
        self._trace = t
        self._obs = deque(maxlen=4096)
        self.supervisor.obs = self._obs
        self._root_span = t.span("fit", worker=self.worker_id,
                                 epoch=int(self.model._epoch),
                                 step=int(self.model._step))
        now = time.perf_counter()
        if cursor is not None:
            t.span("resume", parent=self._root_span,
                   t_start=t_fit0, t_end=now,
                   epoch=int(cursor.get("epoch") or 0),
                   batches_into_epoch=int(
                       cursor.get("batches_into_epoch") or 0))
        if rm is not None:
            t.span("re_mesh", parent=self._root_span,
                   t_start=t_fit0, t_end=now,
                   from_workers=rm[0], to_workers=rm[1])
            self._remesh_reported = True

    def _finish_observed(self, error: bool = False):
        """Rebuild spans from the retro-ring and close the trace. Runs
        once per fit, off the hot path; the writer thread is already
        joined so no more ring appends can race this drain."""
        t = self._trace
        if t is None:
            return
        self._trace = None
        obs, self._obs = self._obs, None
        self.supervisor.obs = None
        root = self._root_span
        self._root_span = None
        if obs:
            for kind, s0, s1, attrs in obs:
                t.span(kind, parent=root, t_start=s0, t_end=s1,
                       **(attrs or {}))
        ph = self._phases
        root.end(
            data_wait_s=round(ph["data_wait_s"], 6),
            device_step_s=round(ph["device_step_s"], 6),
            checkpoint_stall_s=round(
                self.supervisor.checkpoint_stall_s, 6))
        self.tracer.finish(t, error=error)

    def _fit_supervised(self, iterator, epochs: int):
        m = self.model
        if m._params is None:
            m.init()
        sup = self.supervisor
        t_fit0 = time.perf_counter()
        step_fn = self._ensure_step()
        if self.async_write and (self._writer is None
                                 or self._writer.closed):
            self._writer = AsyncCheckpointWriter(self._write_atomic)
        # a plain generator exhausts after one epoch and would silently
        # yield nothing on later epochs — materialize it (same guard as
        # MultiLayerNetwork.fit)
        if not hasattr(iterator, "reset") and \
                not isinstance(iterator, (list, tuple)):
            iterator = list(iterator)
        cursor = getattr(m, "_resume_cursor", None)
        m._resume_cursor = None
        self._begin_observed(cursor, t_fit0)
        # coordinated preemption: notices are generation-based — only
        # a token newer than THIS fit's start counts, so a restarted
        # fleet does not re-preempt itself off last run's sentinel
        if self.coordinator is not None:
            self._coord_gen0 = self.coordinator.generation()
        self._loop_active = True
        try:
            # rollback needs a good snapshot BEFORE the first anomaly
            # can strike (skipped entirely when nothing would ever
            # consume it — see snapshot_every_n_steps)
            if self.snapshot_every_n_steps:
                sup.capture_good(m, cursor=self._current_cursor())
            for e in range(m._epoch, epochs):
                self._run_one_epoch(iterator, step_fn, cursor)
                cursor = None      # only the first epoch resumes
                for lst in m.listeners:
                    if hasattr(lst, "on_epoch_end"):
                        lst.on_epoch_end(m)
                if (e + 1) % self.save_every == 0 or e + 1 == epochs:
                    self._checkpoint(self._ckpt_path(e + 1))
        finally:
            try:
                # durability before fit() returns: an async checkpoint
                # still in flight is not yet a checkpoint (a stored
                # error from an earlier failed background write also
                # surfaces here). _loop_active stays True through this
                # wait ON PURPOSE: a SIGTERM here must take the flag
                # path — the inline handler save would open the same
                # pid-unique temp file the writer thread is mid-writing
                # and rename the interleaved result live
                if self._writer is not None:
                    self._writer.wait()
            finally:
                self._loop_active = False
                requested = self._preempt_requested.is_set()
                if self._ranks > 1:
                    # the ranks meet here (the writer's archives are
                    # committed by now) and agree on a late notice
                    requested, = self.wrapper.agree_any([requested])
                # a SIGTERM that landed after the last step boundary
                # (final epoch checkpoint, writer wait) would otherwise
                # be swallowed: no boundary remains to observe the
                # flag, and the platform's terminate notice must still
                # be honored — flush and run the chaining contract
                # (which re-delivers the default terminate action).
                # Inside this finally so a stale background-write error
                # raised by wait() above cannot skip it. (A signal
                # landing after this check takes the handler's inline
                # path — safe, the writer is idle or dead by now.)
                if requested:
                    self._preempt_requested.clear()
                    sup.preemptions.inc()
                    self._signal_fleet()
                    self._flush_step_checkpoint()
                    handler, self._preempt_handler = \
                        self._preempt_handler, None
                    if handler is not None:
                        handler.finish_preemption(self._preempt_signum)
                if self._writer is not None:
                    # reclaim the writer thread: a process creating
                    # many trainers must not accumulate idle daemons.
                    # The object stays referenced for stats; the next
                    # fit() builds a fresh one
                    self._writer.close()
                self._finish_observed(error=sys.exc_info()[0] is not None)
        return m

    def _run_one_epoch(self, iterator, step_fn, cursor: Optional[dict]):
        m = self.model
        # capture the iterator's replay state BEFORE its epoch reset:
        # a mid-epoch checkpoint stores this state + a batch count, and
        # resume replays the same shuffle order then skips the batches
        # the dead run already trained on
        it_state = (iterator.state_dict()
                    if hasattr(iterator, "state_dict") else None)
        skip = 0
        if cursor is not None and cursor.get("epoch") == m._epoch:
            if cursor.get("iterator") is not None \
                    and hasattr(iterator, "load_state_dict"):
                iterator.load_state_dict(cursor["iterator"])
                it_state = cursor["iterator"]
            skip = int(cursor.get("batches_into_epoch", 0))
        self._epoch_it_state = it_state
        self._batches_done = 0
        obs = self._obs           # None unless a live span ring is
        fleet = self.fleet        # armed — see _begin_observed
        phases = self._phases
        wid = self.worker_id if self.worker_id is not None else 0
        it = iter(iterator)
        while True:
            t_w0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                break
            if skip > 0:
                # fast-forward WITHOUT consuming the model's PRNG key:
                # the checkpointed key already reflects these batches'
                # splits — re-splitting would fork the stream
                skip -= 1
                self._batches_done += 1
                continue
            t_w1 = time.perf_counter()
            self._run_one_step(step_fn, item)
            t_s1 = time.perf_counter()
            phases["data_wait_s"] += t_w1 - t_w0
            phases["device_step_s"] += t_s1 - t_w1
            if obs is not None:
                obs.append(("data_wait", t_w0, t_w1, None))
                obs.append(("device_step", t_w1, t_s1,
                            {"step": int(m._step), "worker": wid}))
            if fleet is not None:
                fleet.observe_step(wid, t_s1 - t_w1)
            self._batches_done += 1
            self._after_step()
        m._epoch += 1
        # roll the cursor to the NEXT epoch's start: an epoch-boundary
        # checkpoint must say "epoch E+1, batch 0, iterator as it
        # stands now", not carry the finished epoch's batch count
        self._batches_done = 0
        self._epoch_it_state = (iterator.state_dict()
                                if hasattr(iterator, "state_dict")
                                else None)

    def _run_one_step(self, step_fn, item):
        m = self.model
        sup = self.supervisor
        x_host, y, msk = m._unpack(item)
        x, y, mj = m._to_device(x_host, y, msk)
        t0 = time.perf_counter()
        tbptt = m.conf.tbptt_fwd_length
        # split ONCE per batch BEFORE the TBPTT branch, exactly like
        # MultiLayerNetwork.fit — the epoch-mode and step-mode loops
        # must consume the key stream identically or a checkpoint
        # taken under one and resumed under the other diverges
        rng_before = m._rng
        rb_before = sup.rollbacks.value()
        keys = R.split(m._rng)
        m._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
        if tbptt and x.ndim == 3 and x.shape[1] > tbptt:
            # TBPTT chunks run through the model's own chunk step
            # (retry/guard don't thread into the chunk loop); the
            # cursor/PRNG machinery still makes them resume bit-exactly
            loss = m._fit_tbptt(x, y, mj, tbptt)
            advanced = True
        else:
            advanced, loss = sup.step(m, step_fn, x, y, mj, sub)
        if advanced:
            m._step += 1
        elif sup.rollbacks.value() == rb_before:
            # a skipped anomalous batch must not consume the key
            # stream either: with per-batch RNG consumers (dropout)
            # the split would make every later batch draw different
            # masks than a run that never saw the bad batch — breaking
            # the skip-identity contract. (NOT on the rollback path:
            # rollback() just restored the snapshot's key, which this
            # would clobber with the newer pre-split one)
            m._rng = rng_before
        m._last_loss = loss
        dur = time.perf_counter() - t0
        for lst in m.listeners:
            lst.iteration_done(m, m._step, m._epoch)
            if hasattr(lst, "on_timing"):
                lst.on_timing(m, dur, len(x_host))
        self._advanced = advanced

    def _after_step(self):
        m = self.model
        sup = self.supervisor
        obs = self._obs
        if self._advanced:
            t0 = time.perf_counter()
            snapped = False
            if self.snapshot_every_n_steps \
                    and m._step % self.snapshot_every_n_steps == 0:
                sup.capture_good(m, cursor=self._current_cursor())
                snapped = True
                if obs is not None:
                    obs.append(("host_snapshot", t0, time.perf_counter(),
                                {"step": int(m._step)}))
            if self.save_every_n_steps \
                    and m._step % self.save_every_n_steps == 0:
                t1 = time.perf_counter()
                if not snapped:
                    sup.capture_good(m, cursor=self._current_cursor())
                    if obs is not None:
                        obs.append(("host_snapshot", t1,
                                    time.perf_counter(),
                                    {"step": int(m._step)}))
                t2 = time.perf_counter()
                self._checkpoint(
                    self._step_ckpt_path(m._epoch, m._step),
                    snap=sup.last_good)
                if obs is not None:
                    obs.append(("checkpoint_submit", t2,
                                time.perf_counter(),
                                {"step": int(m._step)}))
            sup.checkpoint_stall_s += time.perf_counter() - t0
        # preemption checks ride the step boundary: the injected seam
        # (scripted chaos), the SIGTERM flag (real platform notice),
        # and the fleet coordination channel (ANOTHER worker's notice).
        # A locally-originated preemption broadcasts BEFORE flushing,
        # so the rest of the fleet overlaps its flushes with ours
        injected = None
        if self.injector is not None:
            try:
                if self.worker_id is not None:
                    self.injector.fire("preempt", worker=self.worker_id)
                else:
                    self.injector.fire("preempt")
            except PreemptionFault as e:
                injected = e
        requested = self._preempt_requested.is_set()
        local_request = requested
        noticed = (self.coordinator is not None
                   and self._coord_gen0 is not None
                   and self.coordinator.generation() > self._coord_gen0)
        if self._ranks > 1:
            # the ranks of one wrapper stop at the same boundary or none
            # does: a drain's snapshot is a collective over all of them
            any_injected, requested, noticed = self.wrapper.agree_any(
                [injected is not None, requested, noticed])
            if any_injected and injected is None:
                injected = PreemptionFault(
                    f"preempted at step {m._step} with another rank of "
                    "the wrapper; step-granular checkpoint flushed")
        if injected is not None:
            sup.preemptions.inc()
            t_d = time.perf_counter()
            self._signal_fleet()
            self._flush_step_checkpoint()
            if obs is not None:
                obs.append(("preemption_drain", t_d,
                            time.perf_counter(),
                            {"step": int(m._step),
                             "origin": "injected"}))
            raise injected
        if requested:
            self._preempt_requested.clear()
            sup.preemptions.inc()
            t_d = time.perf_counter()
            self._signal_fleet()
            self._flush_step_checkpoint()
            if obs is not None:
                obs.append(("preemption_drain", t_d, time.perf_counter(),
                            {"step": int(m._step), "origin": "sigterm"}))
            handler, self._preempt_handler = self._preempt_handler, None
            if handler is not None and local_request:
                # on_preempt + chaining run HERE, on the loop's thread,
                # with the checkpoint already durable — never inside
                # the signal handler (same flip-the-flag treatment as
                # the serving SIGTERM wiring)
                handler.finish_preemption(self._preempt_signum)
            raise PreemptionFault(
                f"preempted at step {m._step}; step-granular "
                "checkpoint flushed")
        if noticed:
            # fleet-wide drain: some OTHER worker is being preempted —
            # flush our own step-granular checkpoint at this boundary
            # and exit the same way, so the whole fleet stops at a
            # consistent, resumable step
            sup.preemptions.inc()
            sup.preempts_received.inc()
            source = (self.coordinator.last_source
                      if self.coordinator is not None else None)
            if self.events is not None:
                self.events.record(
                    "preempt_received", worker=self.worker_id,
                    step=int(m._step), source=source)
            if self.fleet is not None:
                self.fleet.inc(
                    self.worker_id if self.worker_id is not None
                    else 0, "preempts")
            t_d = time.perf_counter()
            self._flush_step_checkpoint()
            if obs is not None:
                obs.append(("preemption_drain", t_d, time.perf_counter(),
                            {"step": int(m._step), "origin": "fleet"}))
            raise PreemptionFault(
                f"coordinated preemption at step {m._step} (fleet "
                f"notice from worker {source!r}); step-granular "
                "checkpoint flushed")

    def _checkpoint(self, path: str, snap: Optional[dict] = None):
        """Write through the async writer in async mode (the step loop
        stalls only for the snapshot + any previous write still in
        flight), inline otherwise."""
        sup = self.supervisor
        if snap is None:
            snap = snapshot_training_state(
                self.model, cursor=self._current_cursor(),
                extra=self._extra_state())
        if self._writer is not None:
            self._writer.submit(snap, path)
            sup.async_checkpoints.inc()
        else:
            self._write_atomic(snap, path)
            sup.sync_checkpoints.inc()

    def _signal_fleet(self):
        """Broadcast a locally-originated preemption over the
        coordination channel (no-op without one). Runs on the LOOP
        thread — the signal handler itself stays flag-only. The token
        bump also marks our own gen0 as stale, but every locally-
        originated path raises before re-checking the channel, so we
        never double-count our own notice."""
        if self.events is not None:
            self.events.record("preempt_broadcast",
                               worker=self.worker_id,
                               step=int(self.model._step),
                               coordinated=self.coordinator is not None)
        if self.fleet is not None:
            self.fleet.inc(self.worker_id if self.worker_id is not None
                           else 0, "preempts")
        if self.coordinator is None:
            return
        self.supervisor.preempts_broadcast.inc()
        source = (self.worker_id if self.worker_id is not None
                  else os.getpid())
        self.coordinator.signal(source=source)

    def _flush_step_checkpoint(self):
        """Synchronous, durable, step-granular flush — the preemption
        path (the process is about to die; async timing is no good).
        Waits out any in-flight async write first so rotation can't
        race, then writes inline."""
        if self._writer is not None:
            try:
                self._writer.wait()
            except Exception:  # noqa: BLE001 — a stored error from an
                # EARLIER failed background write must not abort the
                # final flush: the process is dying and this inline
                # write is the last chance at a step checkpoint (if the
                # disk is truly gone, the write below raises itself)
                pass
        path = self._step_ckpt_path(self.model._epoch, self.model._step)
        exists = self._writes and os.path.exists(path)
        if self._ranks > 1:
            # the writer's view decides for every rank: the snapshot
            # below gathers over all of them
            exists, = self.wrapper.agree_any([exists])
        if not exists:
            self._write_atomic(
                snapshot_training_state(self.model,
                                        cursor=self._current_cursor(),
                                        extra=self._extra_state()),
                path)
            self.supervisor.sync_checkpoints.inc()

    def faults_snapshot(self) -> dict:
        """Supervisor + injector counters (the training analog of the
        serving ``faults`` stats block)."""
        d = self.supervisor.snapshot()
        if self._writer is not None:
            d["async_write_s_total"] = round(self._writer.write_s_total, 6)
            d["async_writes"] = self._writer.writes
        if self.injector is not None:
            d["injector"] = self.injector.snapshot()
        return d

    def telemetry_snapshot(self) -> dict:
        """The one dict a training metrics plane renders: supervisor
        counters, the step-phase breakdown, the async writer's queue and
        stall state, wrapper telemetry (worker count, re-mesh,
        compression effectiveness: a collective with several ranks) and
        the fleet and event rollups."""
        sup = self.supervisor
        ph = self._phases
        data_wait = ph.get("data_wait_s", 0.0)
        device = ph.get("device_step_s", 0.0)
        wall = data_wait + device + sup.checkpoint_stall_s
        d = {
            "supervisor": sup.snapshot(),
            "phases": {
                "data_wait_s": round(data_wait, 6),
                "device_step_s": round(device, 6),
                "checkpoint_stall_s": round(sup.checkpoint_stall_s, 6),
                "data_wait_frac": (round(data_wait / wall, 4)
                                   if wall > 0 else 0.0),
                "checkpoint_stall_frac": (
                    round(sup.checkpoint_stall_s / wall, 4)
                    if wall > 0 else 0.0),
            },
        }
        if self._writer is not None:
            d["checkpoint_writer"] = self._writer.snapshot()
        if self.fleet is not None:
            d["fleet_workers"] = self.fleet.snapshot()
        if self.events is not None:
            d["events"] = self.events.counts()
        if self.wrapper is not None:
            d["wrapper"] = self.wrapper.telemetry_snapshot()
        return d

    @staticmethod
    def resume(checkpoint_dir: str, device=None):
        """The network of the latest completed checkpoint, on ``device``
        (the card unless ``"cpu"`` is asked for). Handles v1/v2 zip
        files and v3 shard directories; the recorded format version is
        validated up front, so an unknown one fails with an actionable
        :class:`~..util.serializer.CheckpointFormatError` (path, found
        and expected versions). Format-v2+ checkpoints restore the key
        chain and leave the loop cursor and the extra runtime state on
        the model for the next ``fit()`` or ``ParallelWrapper``: resume
        is then bit-exact, mid-epoch included; a v3 checkpoint restored
        by a DIFFERENT worker count is re-bucketed by the resuming
        wrapper (elastic re-meshing, a documented-tolerance contract)."""
        ckpts = FaultTolerantTrainer.list_checkpoints(checkpoint_dir)
        if not ckpts:
            raise FileNotFoundError(
                f"no checkpoints in {checkpoint_dir}")
        # restore() validates the format first thing and dispatches on
        # the saved model_type (MLN vs ComputationGraph)
        return ModelSerializer.restore(ckpts[-1], device=device)


class PreemptionHandler:
    """Checkpoint-on-preemption hook: the platform sends SIGTERM before
    maintenance or preemption, so flush a checkpoint the moment the
    signal lands, then let the process exit and
    `FaultTolerantTrainer.resume` pick it up on restart.

    Usage::

        trainer = FaultTolerantTrainer(model, ckpt_dir)
        with PreemptionHandler(trainer):
            trainer.fit(data, epochs=100)

    When the trainer's SUPERVISED loop is running (step mode), the
    handler only sets a flag — the same treatment as the serving
    SIGTERM wiring, which never does blocking work in the handler
    frame: the interrupted main thread is somewhere inside the step
    loop, possibly holding the async-writer's lock, and a blocking
    in-handler save could deadlock on it. The loop observes the flag
    at the next STEP boundary, flushes a step-granular mid-epoch
    checkpoint, and then runs ``on_preempt`` + chaining on its own
    thread via :meth:`finish_preemption`. Outside the supervised loop
    the handler saves inline as before (the main thread is blocked in
    the handler, so the model state it snapshots cannot move — and the
    epoch-granular path takes no locks the handler could need).

    The handler chains any previously-installed handler (so test
    runners / frameworks keep their own cleanup), marks
    ``preempted`` for the training loop to observe, and is
    installable only from the main thread (signal module rule) —
    elsewhere it degrades to a no-op with ``installed=False``.

    Pass ``coordinator=`` (a
    :class:`~.multihost.PreemptionCoordinator`, installed onto the
    trainer if it has none) and this worker's SIGTERM becomes a
    FLEET-WIDE drain: the handler contract stays flag-only — the
    supervised loop broadcasts over the channel on its own thread at
    the next step boundary, every other worker's loop observes the
    notice at ITS next boundary, and each flushes its own
    step-granular checkpoint before exiting. Outside the supervised
    loop (epoch path) the broadcast happens right after the inline
    save."""

    def __init__(self, trainer: FaultTolerantTrainer,
                 signals=(signal.SIGTERM, signal.SIGINT),
                 on_preempt: Optional[Callable] = None,
                 reraise: bool = True,
                 coordinator: Optional[PreemptionCoordinator] = None):
        self.trainer = trainer
        if coordinator is not None and trainer.coordinator is None:
            trainer.coordinator = coordinator
        self.coordinator = coordinator or trainer.coordinator
        self.signals = tuple(signals)
        self.on_preempt = on_preempt
        self.reraise = reraise
        self.preempted = False
        self.installed = False
        self._prev = {}

    def _handle(self, signum, frame):
        self.preempted = True
        tr = self.trainer
        if getattr(tr, "_loop_active", False):
            # supervised loop running beneath this very frame: hand off
            # (flag only) — it flushes at the next step boundary and
            # calls finish_preemption()
            tr._preempt_handler = self
            tr._preempt_signum = signum
            tr._preempt_requested.set()
            return
        # flush the current (possibly mid-epoch) training state — but
        # never clobber an existing clean epoch-boundary checkpoint with
        # the same tag, and never re-enter a _save the signal interrupted
        # mid-write (the shared .tmp would corrupt the live checkpoint;
        # skipping keeps the previous checkpoint intact)
        epoch = tr.model._epoch
        if not getattr(tr, "_saving", False) and \
                not os.path.exists(tr._ckpt_path(epoch)):
            tr._save(epoch)
        # epoch path: broadcast AFTER the inline save (the main thread
        # is blocked in this handler anyway; the supervised loop's
        # flag path broadcasts from the loop thread instead)
        tr._signal_fleet()
        self.finish_preemption(signum, frame)

    def finish_preemption(self, signum, frame=None):
        """Run the user callback and the chaining contract — called
        from the handler itself (epoch path) or from the supervised
        loop's thread after its step-granular flush."""
        if self.on_preempt is not None:
            self.on_preempt(signum)
        prev = self._prev.get(signum)
        if self.reraise:
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                # emulate the default action (terminate) so the doomed
                # process actually exits after checkpointing.
                # signal.signal is main-thread-only: when the loop runs
                # elsewhere, skip re-arming rather than die on
                # ValueError with the checkpoint already safe
                try:
                    signal.signal(signum, signal.SIG_DFL)
                except ValueError:
                    return
                os.kill(os.getpid(), signum)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.getsignal(s)
                signal.signal(s, self._handle)
            self.installed = True
        return self

    def __exit__(self, *exc):
        if self.installed:
            for s in self.signals:
                signal.signal(s, self._prev[s])
            self.installed = False
        return False


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None):
    """Join this process to a multi-process ``torch.distributed`` world
    (JAX's wraps ``jax.distributed.initialize``): ``init_process_group``
    at ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this
    one ``process_id``. With no arguments the ``torch.distributed``
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) gives them. ``num_processes=1`` is the explicit
    single-process no-op and returns False; otherwise returns True.

    The backend is NCCL for CUDA tensors (gloo for host ones) when every
    rank has a card of its own, and gloo otherwise, several ranks on one
    card included. Where the machine has cards,
    rank ``r`` takes ``cuda:{r % device_count}`` as its current device,
    so a model built on the card by default lands on its own."""
    import torch
    import torch.distributed as dist
    if num_processes == 1:
        return False
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        init, n, rank = "env://", int(os.environ["WORLD_SIZE"]), \
            int(os.environ["RANK"])
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize_cluster needs coordinator_address,"
                             " num_processes and process_id together")
        init, n, rank = (f"tcp://{coordinator_address}",
                         int(num_processes), int(process_id))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "cpu:gloo,cuda:nccl" if cards >= n else "gloo"
    if cards:
        torch.cuda.set_device(rank % cards)
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank)
    return True
