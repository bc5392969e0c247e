"""Data-parallel training on ``torch.distributed`` (counterpart of the
data-parallel half of ``deeplearning4j_tpu/parallel/__init__.py``),
plain attention (``longseq.py``), the resilient-training runtime
(``resilience.py``, ``elastic.py``), multi-process helpers and the
preemption coordinator (``multihost.py``), gradient compression
(``compression.py``) and training telemetry (``telemetry.py``).

JAX compiles one SPMD program over a device mesh; here one worker is
one process, a rank of a ``torch.distributed`` world, and the mesh is a
grid of ranks with a process group per axis (:func:`make_mesh`; a
process that never initialised ``torch.distributed`` is a mesh of one
worker). The capabilities map:

- ParallelWrapper (data parallelism)  -> :class:`ParallelWrapper`: the
  dense step equals the model's own step on the global batch (batch
  norm's statistics, the loss's normalisation and the dropout masks are
  the global batch's, ``nn/global_batch.py``), with the ranks'
  gradients summed in one collective a step;
- SharedTrainingMaster / gradient sharing -> ``accumulator=
  GradientSharingAccumulator(...)``: each worker's Strom-quantised
  update (or gradient) and residual, averaged over the ranks;
- ParallelInference -> :class:`ParallelInference`: rows split over the
  ranks and gathered.

The collectives (``transport.py``) move a step's tensors as one flat
buffer per dtype: NCCL when every rank has a card of its own, gloo
otherwise (several ranks on one card, or the CPU), where CUDA tensors
are staged through pinned host memory.

Tensor, pipeline, expert and sequence parallelism and the 4D
transformer (JAX's ``tensor.py``, ``pipeline.py``, ``moe.py``,
``transformer.py`` and ``longseq.py``'s blockwise and ring attention)
are ROADMAP.md queue A, item 14b.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..nn.global_batch import LocalShard
from . import transport as T


class PartitionSpec(tuple):
    """Which mesh axis shards each array axis (None: not sharded), as
    JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """A grid of global ranks with named axes (JAX's ``Mesh`` over
    devices). Building one creates a process group for every line of
    ranks along each axis and one over the whole mesh, so every rank of
    the world builds every mesh the same way and in the same order, as
    ``torch.distributed.new_group`` requires. ``coords`` is this rank's
    place in the grid (None when it is not in the mesh)."""

    def __init__(self, ranks, axis_names: Sequence[str] = ("data",
                                                           "model")):
        grid = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-D grid of ranks needs "
                             f"{grid.ndim} axis names, got "
                             f"{self.axis_names}")
        self.devices = grid
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.size = int(grid.size)
        me = T.rank()
        hit = np.argwhere(grid == me)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self._transports: Dict[str, T.Transport] = {}
        self._whole: Optional[T.Transport] = None
        if not T.initialized():
            if self.size != 1 or int(grid.reshape(-1)[0]) != 0:
                raise ValueError(
                    f"a mesh of ranks {grid.reshape(-1).tolist()} needs "
                    "torch.distributed (parallel.elastic."
                    "initialize_cluster)")
            return
        if int(grid.max()) >= T.world_size() or int(grid.min()) < 0:
            raise ValueError(f"ranks {grid.reshape(-1).tolist()} are not "
                             f"all in a world of {T.world_size()}")
        made: Dict[tuple, Optional[T.Transport]] = {}

        def transport(line):
            """The line's group (created once, by every rank) and, on
            its members, its transport."""
            key = tuple(int(r) for r in line)
            if key not in made:
                g = dist.new_group(list(key))
                made[key] = T.Transport(g, key) if me in key else None
            return made[key]

        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines:
                if len(line) < 2:
                    continue
                tr = transport(line)
                if tr is not None:
                    self._transports[name] = tr
        if self.size > 1:
            self._whole = transport(grid.reshape(-1))

    def transport(self, axis: str) -> Optional[T.Transport]:
        """The collectives along ``axis`` through this rank (None when
        the axis has one rank or this rank is not in the mesh)."""
        return self._transports.get(axis)

    def whole(self) -> Optional[T.Transport]:
        """The collectives over every rank of the mesh."""
        return self._whole

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"


def make_mesh(devices: Optional[Sequence[int]] = None,
              data: Optional[int] = None, model: int = 1) -> Mesh:
    """A 2D ("data", "model") mesh over ``devices`` (global ranks; every
    rank of the world by default), all on the data axis unless ``data``
    and ``model`` say otherwise."""
    ranks = list(devices if devices is not None
                 else range(T.world_size()))
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(
            f"data({data}) * model({model}) != device count ({n})")
    return Mesh(np.asarray(ranks).reshape(data, model), ("data", "model"))


def rebucket_worker_array(arr: np.ndarray, new_w: int) -> np.ndarray:
    """Re-bucket a per-worker state array ``[W, ...]`` onto ``new_w``
    workers (elastic re-meshing of gradient-sharing residuals and
    per-worker updater moments).

    The rule keeps the quantity the training math consumes, the
    per-step mean ``(1/W) * sum_w state_w``:

    - shrink, ``W % new_w == 0``: each new worker takes the MEAN of its
      group of ``W/new_w`` old workers;
    - grow, ``new_w % W == 0``: each old worker's state is REPLICATED
      to its ``new_w/W`` children;
    - otherwise the global mean is replicated to every new worker.

    A same-shape resume never reaches this function (bit for bit); a
    re-meshed resume is a documented-tolerance contract
    (docs/distributed.md)."""
    arr = np.asarray(arr)
    w = arr.shape[0]
    new_w = int(new_w)
    if new_w < 1:
        raise ValueError(f"new_w must be >= 1, got {new_w}")
    if w == new_w:
        return arr
    if w % new_w == 0:
        g = w // new_w
        out = arr.reshape((new_w, g) + arr.shape[1:]).mean(axis=1)
    elif new_w % w == 0:
        out = np.repeat(arr, new_w // w, axis=0)
    else:
        out = np.broadcast_to(arr.mean(axis=0, keepdims=True),
                              (new_w,) + arr.shape[1:])
    return np.ascontiguousarray(out).astype(arr.dtype, copy=False)


# -- trees of tensors ----------------------------------------------------
def _named(tree, prefix: str = "") -> List[tuple]:
    """(key, leaf) pairs in the checkpoint's order (sorted dict keys,
    ``a/b/c`` names: ``util/serializer.py``'s ``_flatten_tree``)."""
    from ..util.serializer import _is_node, _items
    out = []
    for k, v in _items(tree):
        key = f"{prefix}/{k}" if prefix else k
        out.extend(_named(v, key) if _is_node(v) else [(key, v)])
    return out


def _rebuild(tree, leaves):
    """``tree``'s layout with its leaves, in :func:`_named`'s order,
    taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _reciprocal(n: int) -> float:
    """``1 / n`` rounded to f32: a mean or a fraction divides as XLA
    computes it, by a multiply with the f32 reciprocal of the constant
    (exact for a power of two), so the carried sparsity and threshold
    equal JAX's bit for bit."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(float(n), dtype=torch.float32))


def _local_rows(mesh: Mesh, axis: str, *arrays):
    """This rank's rows of each global batch array (a ``LocalShard`` is
    already this rank's): rows ``[i * b, (i + 1) * b)`` for data index
    ``i`` of ``n``, ``b = rows / n``."""
    n = mesh.shape[axis]
    i = mesh.coords[mesh.axis_names.index(axis)]
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif isinstance(a, LocalShard):
            out.append(a.local)
        elif n == 1:
            out.append(a)
        else:
            rows = a.shape[0]
            if rows % n:
                raise ValueError(
                    f"a batch of {rows} rows does not split over the "
                    f"{n} workers of the {axis!r} axis")
            b = rows // n
            out.append(a[i * b:(i + 1) * b])
    return out


def jit_sharded_step(model, mesh: Mesh, axis: str = "data",
                     guard: bool = False):
    """THE data-parallel contract of a training step, shared by
    ParallelWrapper and ``multihost.build_multihost_step``: a pure step
    ``(params, opt_state, net_state, step, x, y, mask, rng) -> (params,
    opt_state, net_state, loss[, ok])`` that equals the model's own step
    on the GLOBAL batch. Every rank of the mesh calls it with the same
    replicated state and either the global batch (it takes its rows) or
    its ``LocalShard`` of it. Inside, each rank runs the forward and
    backward on its rows under the global-batch view
    (``nn/global_batch.py``: batch norm's statistics, the loss's divisor
    and the dropout masks of the global batch), the ranks' gradients and
    loss shares are summed in ONE collective, and the update half (the
    guard, clipping, the updaters, constraints) runs on the sums, the
    same on every rank. With one worker it is the model's own step."""
    if model._params is None:
        model.init()
    tr = mesh.transport(axis)
    if tr is None:
        base = model._make_step_fn(guard=guard)
    else:
        from ..nn import global_batch as G
        index = mesh.coords[mesh.axis_names.index(axis)]
        count = mesh.shape[axis]

        def grads_fn(leaves, net_state, x, y, mask, rng):
            with G.over(index, count, tr.sum):
                loss, grads, new_net, _ = model._grads(
                    leaves, net_state, x, y, mask, True, rng)
            names = [(k, n) for k in grads for n in grads[k]]
            summed = tr.all_reduce([grads[k][n] for k, n in names]
                                   + [loss.reshape(1)])
            out = {k: {} for k in grads}
            for (k, n), g in zip(names, summed):
                out[k][n] = g
            return summed[-1].reshape(()), out, new_net

        base = model._make_step_fn(guard=guard, grads_fn=grads_fn)

    def step_fn(params, opt_state, net_state, step, x, y, mask, rng):
        x, y, mask = _local_rows(mesh, axis, x, y, mask)
        return base(params, opt_state, net_state, step, x, y, mask, rng)

    return step_fn


class GradientSharingAccumulator:
    """Configuration and carried state of Strom-style compressed update
    sharing inside the data-parallel step (ref:
    `EncodedGradientsAccumulator.java:59`, `EncodingHandler.java:51`,
    `StochasticGradientDescent.optimize:52-93`).

    Each worker (rank) quantises (update + residual) to ±threshold where
    ``|u| >= threshold``, keeps the remainder as its own residual, and
    the decoded updates are averaged over the ranks. The threshold
    adapts every step toward a target sparsity band (ref:
    AdaptiveThresholdAlgorithm).

    Quantisation is in the UPDATE domain, like the reference: each
    worker runs its OWN updater on its local gradients first, then
    encodes the resulting update. Adam fed quantised gradients would
    turn every sparse firing into a full-size step.

    State (this rank's residual and updater state, the threshold, the
    last sparsity) lives on the device between steps: each rank keeps
    its own worker's residual and moments, as the reference's workers
    do, and the checkpoint gathers them (``ParallelWrapper.
    extra_checkpoint_state``). The model's ``opt_state`` is refreshed
    every step from this rank's live moments, so rank 0's (worker 0's,
    the ones its checkpoints take) always pair with the params.

    Two modes; ``"update"`` is the DEFAULT, as in the JAX package's code
    (its ``docs/distributed.md`` calls ``"gradient"`` the default; the
    code is right):

    - ``"update"``: per-worker updater, then sign*threshold quantisation
      of the UPDATE (wire: index + sign);
    - ``"gradient"``: quantise the GRADIENT, sending each fired entry's
      TRUE value, average the decoded gradients and run ONE shared
      updater on the result (the model's own ``opt_state``, the same on
      every rank). The residual carry is unchanged."""

    def __init__(self, threshold: float = 1e-3, adaptive: bool = True,
                 min_sparsity: float = 1e-4, max_sparsity: float = 1e-2,
                 adapt_factor: float = 1.2, mode: str = "update"):
        if mode not in ("update", "gradient"):
            raise ValueError(f"mode must be 'update' or 'gradient': {mode}")
        self.initial_threshold = float(threshold)
        self.adaptive = bool(adaptive)
        self.min_sparsity = float(min_sparsity)
        self.max_sparsity = float(max_sparsity)
        self.adapt_factor = float(adapt_factor)
        self.mode = mode
        # carried (device) state, installed when ParallelWrapper builds
        # its step: this rank's worker's residual and (update mode)
        # updater state, the threshold and the last sparsity
        self.residuals = None
        self.threshold = None
        self.last_sparsity = None
        self.opt_state = None


class ParallelWrapper:
    """Data-parallel training (ref: `ParallelWrapper.java:77-91`,
    modes AVERAGING / SHARED_GRADIENTS).

    Every rank of the mesh's data axis builds the same wrapper over its
    own copy of the same model and calls :meth:`fit` (or a resilient
    trainer's loop) with the same data: the global batches (each rank
    takes its rows) or, with several processes and a
    ``DataSetIterator``, each process's own rows of them
    (``multihost.MultiHostIterator``). The dense step is exact
    synchronous gradient sharing at every step
    (:func:`jit_sharded_step`); ``accumulator=
    GradientSharingAccumulator(...)`` trains with the reference's
    compressed-update semantics (threshold quantisation and per-worker
    residual carry) instead, the CUSTOM/SHARED_GRADIENTS mode of
    `SharedTrainingWrapper.java:79`.

    The first step build broadcasts the mesh's first rank's params,
    updater state and layer state to the others, so every rank starts
    from the same state."""

    def __init__(self, model, mesh: Optional[Mesh] = None,
                 prefetch_buffer: int = 2, workers: Optional[int] = None,
                 accumulator: Optional[GradientSharingAccumulator] = None):
        self.model = model
        if mesh is None:
            ranks = list(range(T.world_size()))
            mesh = make_mesh(ranks[:workers] if workers else None)
        self.mesh = mesh
        if mesh.coords is None:
            raise ValueError(f"rank {T.rank()} is not in the mesh "
                             f"{mesh.devices.tolist()}")
        self.prefetch_buffer = prefetch_buffer
        self.accumulator = accumulator
        self._sharded_step = None
        self._sharded_step_guard = False
        self._step_cache = {}   # guard flag -> step
        self._synced = False
        #: (from_workers, to_workers) of the last elastic re-mesh this
        #: wrapper performed while consuming checkpoint state; None
        #: when every restore so far was same-shape (bit for bit)
        self.last_remesh = None

    @property
    def num_workers(self) -> int:
        return int(self.mesh.shape["data"])

    @property
    def worker_index(self) -> int:
        """This rank's worker: its index on the data axis."""
        return self.mesh.coords[self.mesh.axis_names.index("data")]

    @property
    def writes_checkpoints(self) -> bool:
        """Whether this rank writes the trainer's archives: the mesh's
        first rank does, the others contribute their state to it."""
        return all(c == 0 for c in self.mesh.coords)

    def collective_stats(self) -> dict:
        """The data axis's collectives so far: calls, bytes and host
        seconds (``transport.Transport.stats``)."""
        tr = self.mesh.transport("data")
        return dict(tr.stats) if tr is not None else \
            {"calls": 0, "bytes": 0, "seconds": 0.0}

    def sum_over_workers(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis (a collective)."""
        tr = self.mesh.transport("data")
        return t if tr is None else tr.sum(t)

    def agree_any(self, flags: Sequence[bool]) -> List[bool]:
        """Each flag OR-ed over every rank of the mesh (a collective):
        the ranks' step-boundary decisions made as one."""
        tr = self.mesh.whole()
        if tr is None:
            return [bool(f) for f in flags]
        # a host tensor, unless the group has no gloo half to take it
        dev = "cpu" if "gloo" in tr.backend else self.model.device
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=dev)
        return [bool(v) for v in
                tr.all_reduce([t], op=dist.ReduceOp.MAX)[0].tolist()]

    def telemetry_snapshot(self) -> dict:
        """Wrapper telemetry for the training metrics plane: worker
        count, the last elastic re-mesh (if any), and gradient-
        compression effectiveness (achieved sparsity, residual norm,
        bytes on the wire against dense). A collective that reads device
        values: every rank calls it, at snapshot cadence."""
        from .telemetry import compression_stats
        d = {"workers": self.num_workers}
        if self.last_remesh is not None:
            d["remesh_from"], d["remesh_to"] = (
                int(self.last_remesh[0]), int(self.last_remesh[1]))
        comp = compression_stats(self)
        if comp is not None:
            d["compression"] = comp
        return d

    # -- step builds -----------------------------------------------------
    def _sync_model(self):
        """Every rank takes the mesh's first rank's params, updater
        state and layer state (one broadcast, in place)."""
        tr = self.mesh.whole()
        if tr is None or self._synced:
            self._synced = True
            return
        m = self.model
        leaves = [t for tree in (m._params, m._opt_state, m._net_state)
                  for _, t in _named(tree or {})]
        got = tr.broadcast([t.detach() for t in leaves],
                           src=int(self.mesh.devices.reshape(-1)[0]))
        with torch.no_grad():
            for t, g in zip(leaves, got):
                t.copy_(g)
        self._synced = True

    def _build_step(self, guard: bool = False):
        m = self.model
        if m._params is None:
            m.init()
        self._sync_model()
        self._sharded_step_guard = guard
        if self.accumulator is not None:
            self._sharded_step = self._build_compressed_step(guard=guard)
        else:
            self._sharded_step = jit_sharded_step(m, self.mesh, guard=guard)
        self._step_cache[guard] = self._sharded_step

    def ensure_step(self, guard: bool = False):
        """This wrapper's step, built once PER GUARD VARIANT and cached
        (the resilient trainer's entry point)."""
        cached = self._step_cache.get(guard)
        if cached is None:
            self._build_step(guard=guard)
        else:
            self._sharded_step = cached
            self._sharded_step_guard = guard
        return self._sharded_step

    # -- resilient-training state hooks --------------------------------
    def _gather(self, tree) -> Dict[str, np.ndarray]:
        """Every worker's copy of a tree stacked ``[W, ...]``, as host
        arrays by checkpoint key (a collective over the data axis)."""
        from ..util.serializer import _host
        named = _named(tree)
        tr = self.mesh.transport("data")
        if tr is None:
            stacked = [t.detach()[None] for _, t in named]
        else:
            stacked = tr.all_gather([t.detach() for _, t in named])
        return {k: _host(t) for (k, _), t in zip(named, stacked)}

    def extra_checkpoint_state(self):
        """Flat ``{key: host ndarray}`` of the accumulator's carried
        state: every worker's residual and (update mode) updater state,
        stacked ``[W, ...]`` under JAX's ``gradient_sharing/...`` keys,
        the threshold and the last sparsity. ``None`` when there is
        nothing beyond the model. A collective: every rank calls it."""
        acc = self.accumulator
        if acc is None or acc.residuals is None:
            return None
        from ..util.serializer import _host
        flat = {f"gradient_sharing/residuals/{k}": v
                for k, v in self._gather(acc.residuals).items()}
        flat["gradient_sharing/threshold"] = _host(acc.threshold)
        flat["gradient_sharing/last_sparsity"] = _host(acc.last_sparsity)
        if acc.opt_state is not None:
            flat.update({f"gradient_sharing/opt_state/{k}": v
                         for k, v in self._gather(acc.opt_state).items()})
        return flat

    def _rebucket_flat(self, flat):
        """Re-bucket a flat dict of per-worker ``[W, ...]`` arrays onto
        this wrapper's worker count when the checkpoint was written by a
        DIFFERENT fleet shape; records the transition in
        ``last_remesh``."""
        if not flat:
            return flat
        ndev = self.num_workers
        widths = {np.asarray(v).shape[0] for v in flat.values()}
        if len(widths) != 1:
            raise ValueError(
                f"inconsistent per-worker leading axes in checkpoint "
                f"extra state: {sorted(widths)}")
        w = widths.pop()
        if w == ndev:
            return flat
        self.last_remesh = (int(w), int(ndev))
        return {k: rebucket_worker_array(v, ndev)
                for k, v in flat.items()}

    def _worker_tree(self, template, flat):
        """This worker's rows of per-worker arrays, in ``template``'s
        layout, on the model's device."""
        from ..util.serializer import _unflatten_like
        i = self.worker_index
        rows = {k: np.asarray(v)[i] for k, v in flat.items()}
        dev = self.model.device
        tree = _unflatten_like(template, rows)
        return _rebuild(tree, iter([t.to(dev) for _, t in _named(tree)]))

    def load_extra_checkpoint_state(self, flat):
        """Inverse of :meth:`extra_checkpoint_state`: this rank's worker
        takes its row of each per-worker array (re-bucketed onto this
        wrapper's worker count when the archive was written by another,
        :func:`rebucket_worker_array`) and the scalar carries."""
        acc = self.accumulator
        if acc is None or acc.residuals is None or not flat:
            return
        gs = {k[len("gradient_sharing/"):]: v for k, v in flat.items()
              if k.startswith("gradient_sharing/")}
        if not gs:
            return
        dev = self.model.device
        res_flat = self._rebucket_flat(
            {k[len("residuals/"):]: v for k, v in gs.items()
             if k.startswith("residuals/")})
        if res_flat:
            acc.residuals = self._worker_tree(acc.residuals, res_flat)
        if "threshold" in gs:
            acc.threshold = torch.tensor(
                float(np.float32(gs["threshold"])), dtype=torch.float32,
                device=dev)
        if "last_sparsity" in gs:
            acc.last_sparsity = torch.tensor(
                float(np.float32(gs["last_sparsity"])),
                dtype=torch.float32, device=dev)
        opt_flat = self._rebucket_flat(
            {k[len("opt_state/"):]: v for k, v in gs.items()
             if k.startswith("opt_state/")})
        if opt_flat and acc.opt_state is not None:
            acc.opt_state = self._worker_tree(acc.opt_state, opt_flat)

    def _init_accumulator_state(self, per_worker_opt: bool):
        """First-build installation of the accumulator's carried state
        (zero residual, the initial threshold, this worker's copy of the
        model's updater state), then any resume state a restored
        checkpoint left on the model, so ``FaultTolerantTrainer.resume()``
        and a fresh wrapper continue with the residuals and moments the
        run died with."""
        from ..nn.multilayer import _clone_tree, _tree_map
        m, acc = self.model, self.accumulator
        dev = m.device
        acc.residuals = _tree_map(lambda p: torch.zeros_like(p.detach()),
                                  m._params)
        acc.threshold = torch.tensor(acc.initial_threshold,
                                     dtype=torch.float32, device=dev)
        acc.last_sparsity = torch.tensor(0.0, dtype=torch.float32,
                                         device=dev)
        if per_worker_opt:
            acc.opt_state = _clone_tree(m._opt_state)
        resume = getattr(m, "_resume_extra", None)
        if resume:
            self.load_extra_checkpoint_state(dict(resume))
            m._resume_extra = None   # consumed

    def _build_compressed_step(self, guard: bool = False):
        """The gradient-sharing step in the reference's UPDATE domain
        (`StochasticGradientDescent.java:52-93`): each worker's local
        gradients, clipped, go through its OWN updater; the update plus
        its residual is threshold-quantised; the decoded updates are
        averaged over the ranks (one collective with the layer state,
        the loss, the sparsity and the guard's flag); params move by
        ``p - u`` and constraints.

        The step keeps the dense step's signature; the accumulator
        carries the per-worker state between calls, and the model's
        ``opt_state`` is refreshed every step from this worker's live
        moments (rank 0's are worker 0's, which its checkpoints take)."""
        from .compression import adapt_threshold, strom_encode_decode
        from ..nn.multilayer import (_clip_grads, _clone_tree, _finite_ok,
                                     _select_ok, _tree_map)
        from ..nn.conf.constraint import apply_constraints
        if self.accumulator.mode == "gradient":
            return self._build_gradient_compressed_step(guard=guard)
        m, acc = self.model, self.accumulator
        if acc.residuals is None:
            self._init_accumulator_state(per_worker_opt=True)
        mesh = self.mesh
        tr = mesh.transport("data")
        w = self.num_workers
        conf = m.conf

        def step_like(params, opt_state, net_state, step, x, y, mask, rng):
            # opt_state is the model's mirror: the live per-worker
            # moments are the accumulator's
            x, y, mask = _local_rows(mesh, "data", x, y, mask)
            leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
            loss, grads, new_net, _ = m._grads(leaves, net_state, x, y,
                                               mask, True, rng)
            if guard:
                ok = _finite_ok(loss, grads)
            grads = _clip_grads(grads, conf.max_grad_norm,
                                conf.grad_clip_value)
            with torch.no_grad():
                new_opt, updates = {}, {}
                for i, key in enumerate(m._layer_keys):
                    if key not in params:
                        continue
                    new_opt[key], updates[key] = m._updaters[i].apply(
                        _clone_tree(acc.opt_state[key]), grads[key], step)
                shared, new_res, loss, sparsity, new_net, ok = \
                    self._share(updates, acc.residuals, new_net, loss,
                                ok if guard else None, strom_encode_decode,
                                tr, w)
                new_thr = adapt_threshold(
                    acc.threshold, sparsity, acc.min_sparsity,
                    acc.max_sparsity, acc.adapt_factor) \
                    if acc.adaptive else acc.threshold
                new_params = {}
                for i, key in enumerate(m._layer_keys):
                    if key not in params:
                        continue
                    new_p = {n: t.detach() - shared[key][n]
                             for n, t in params[key].items()}
                    layer = m.layers[i]
                    if layer.constraints:
                        new_p = apply_constraints(layer.constraints, new_p,
                                                  layer.bias_param_names())
                    new_params[key] = new_p
                if guard:
                    # a skip keeps the residual and the threshold too: a
                    # NaN batch must not leak into the error feedback
                    new_params = _select_ok(
                        ok, new_params, _tree_map(torch.Tensor.detach,
                                                  params))
                    new_opt = _select_ok(ok, new_opt, acc.opt_state)
                    new_net = _select_ok(ok, new_net, net_state)
                    new_res = _select_ok(ok, new_res, acc.residuals)
                    new_thr = torch.where(ok, new_thr, acc.threshold)
                acc.opt_state, acc.residuals = new_opt, new_res
                acc.threshold, acc.last_sparsity = new_thr, sparsity
            if guard:
                return new_params, acc.opt_state, new_net, loss, ok
            return new_params, acc.opt_state, new_net, loss

        return step_like

    def _build_gradient_compressed_step(self, guard: bool = False):
        """The ``mode="gradient"`` step: each worker's local gradients,
        clipped, plus its residual are threshold-fired with their TRUE
        values (`compression.strom_value_encode_decode`); the decoded
        gradients are averaged over the ranks and ONE shared updater
        (the model's own ``opt_state``, the same on every rank) turns
        the mean into the update."""
        from .compression import adapt_threshold, strom_value_encode_decode
        from ..nn.multilayer import (_clip_grads, _clone_tree, _finite_ok,
                                     _select_ok, _tree_map)
        from ..nn.conf.constraint import apply_constraints
        m, acc = self.model, self.accumulator
        if acc.residuals is None:
            self._init_accumulator_state(per_worker_opt=False)
        mesh = self.mesh
        tr = mesh.transport("data")
        w = self.num_workers
        conf = m.conf

        def step_like(params, opt_state, net_state, step, x, y, mask, rng):
            x, y, mask = _local_rows(mesh, "data", x, y, mask)
            leaves = _tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
            loss, grads, new_net, _ = m._grads(leaves, net_state, x, y,
                                               mask, True, rng)
            if guard:
                ok = _finite_ok(loss, grads)
            grads = _clip_grads(grads, conf.max_grad_norm,
                                conf.grad_clip_value)
            with torch.no_grad():
                shared_g, new_res, loss, sparsity, new_net, ok = \
                    self._share(grads, acc.residuals, new_net, loss,
                                ok if guard else None,
                                strom_value_encode_decode, tr, w)
                new_thr = adapt_threshold(
                    acc.threshold, sparsity, acc.min_sparsity,
                    acc.max_sparsity, acc.adapt_factor) \
                    if acc.adaptive else acc.threshold
                new_opt, new_params = {}, {}
                for i, key in enumerate(m._layer_keys):
                    if key not in params:
                        continue
                    new_opt[key], upd = m._updaters[i].apply(
                        _clone_tree(opt_state[key]), shared_g[key], step)
                    new_p = {n: t.detach() - upd[n]
                             for n, t in params[key].items()}
                    layer = m.layers[i]
                    if layer.constraints:
                        new_p = apply_constraints(layer.constraints, new_p,
                                                  layer.bias_param_names())
                    new_params[key] = new_p
                if guard:
                    new_params = _select_ok(
                        ok, new_params, _tree_map(torch.Tensor.detach,
                                                  params))
                    new_opt = _select_ok(ok, new_opt, opt_state)
                    new_net = _select_ok(ok, new_net, net_state)
                    new_res = _select_ok(ok, new_res, acc.residuals)
                    new_thr = torch.where(ok, new_thr, acc.threshold)
                acc.residuals = new_res
                acc.threshold, acc.last_sparsity = new_thr, sparsity
            if guard:
                return new_params, new_opt, new_net, loss, ok
            return new_params, new_opt, new_net, loss

        return step_like

    def _share(self, values, residuals, new_net, loss, ok, encode, tr, w):
        """One worker's encode and the mean over the ranks, in ONE
        collective: each leaf of ``values`` plus its residual through
        ``encode``; the decoded leaves, the layer state, the loss, the
        fired fraction (``|decoded| > 0`` over all entries) and the
        guard's not-ok flag summed over the data axis, then divided by
        ``w`` (JAX's ``pmean``, as a multiply by the f32 ``1 / w``; the
        guard agrees when no worker failed, JAX's ``pmin``). Returns
        (mean decoded tree, new residual tree, mean loss, mean sparsity,
        mean layer state, global ok)."""
        keys = [(k, n) for k in values for n in values[k]]
        enc = [encode(values[k][n], residuals[k][n], self.accumulator
                      .threshold) for k, n in keys]
        fired = sum(torch.sum(torch.abs(d) > 0) for d, _ in enc)
        total = sum(d.numel() for d, _ in enc)
        sparsity = fired.to(torch.float32) * _reciprocal(total)
        net_named = _named(new_net)
        payload = [d for d, _ in enc] + [t for _, t in net_named] \
            + [loss.reshape(1), sparsity.reshape(1)]
        if ok is not None:
            payload.append((~ok).to(torch.float32).reshape(1))
        if tr is not None:
            payload = tr.all_reduce(payload)
        nd, nn_ = len(enc), len(net_named)
        shared = {k: {} for k in values}
        new_res = {k: {} for k in values}
        inv_w = _reciprocal(w)
        for (k, n), d, (_, r) in zip(keys, payload[:nd], enc):
            shared[k][n] = d * inv_w
            new_res[k][n] = r
        mean_net = _rebuild(new_net, iter(
            [t * inv_w for t in payload[nd:nd + nn_]]))
        loss = (payload[nd + nn_] * inv_w).reshape(())
        sparsity = (payload[nd + nn_ + 1] * inv_w).reshape(())
        if ok is not None:
            ok = (payload[nd + nn_ + 2] == 0).reshape(())
        return shared, new_res, loss, sparsity, mean_net, ok

    # -- training ------------------------------------------------------
    def fit(self, iterator, epochs: int = 1):
        """Train data-parallel through ``MultiLayerNetwork.fit`` with this
        wrapper's step swapped into the model's step seam (and swapped
        back after), so iterator unpacking, listeners and epoch
        accounting are single-process training's. Batches must divide
        by the data axis's size; each rank takes its rows of every
        global batch. With several processes a ``DataSetIterator``
        yields each process's OWN rows instead
        (``multihost.MultiHostIterator`` wraps it)."""
        m = self.model
        if m._params is None:
            m.init()
        # the UNGUARDED variant: a trainer may have cached the guarded
        # step (5 outputs) on this wrapper
        self.ensure_step(guard=False)
        from ..datasets import AsyncDataSetIterator, DataSetIterator
        if (self.prefetch_buffer and isinstance(iterator, DataSetIterator)
                and not isinstance(iterator, AsyncDataSetIterator)):
            iterator = AsyncDataSetIterator(iterator,
                                            prefetch=self.prefetch_buffer)
        if T.world_size() > 1:
            from .multihost import MultiHostIterator
            if (isinstance(iterator, DataSetIterator)
                    and not isinstance(iterator, MultiHostIterator)):
                iterator = MultiHostIterator(iterator, self.mesh)
        prev_step = m._jit_step
        m._jit_step = self._sharded_step
        try:
            with self.mesh:
                m.fit(iterator, epochs=epochs)
        finally:
            m._jit_step = prev_step
        return m


class ParallelInference:
    """Sharded batched inference (ref: `ParallelInference.java:55`):
    each rank of the data axis runs the forward on its rows of the
    batch and the rows are gathered, so every rank returns the whole
    batch's output, ``output()``'s."""

    def __init__(self, model, mesh: Optional[Mesh] = None):
        self.model = model
        self.mesh = mesh or make_mesh()

    def output(self, x):
        m = self.model
        if m._params is None:
            m.init()
        xd = m._to_device(x)[0]
        local, = _local_rows(self.mesh, "data", xd)
        out = m.output(local)
        tr = self.mesh.transport("data")
        if tr is None:
            return out
        full = tr.all_gather([out])[0]
        return full.reshape((-1,) + tuple(out.shape[1:]))


from .compression import (EncodedGradientsAccumulator,  # noqa: E402
                          EncodingHandler, LoopbackBus, threshold_decode,
                          threshold_encode, topk_decode, topk_encode)
from .longseq import dot_product_attention  # noqa: E402,F401

__all__ = ["Mesh", "PartitionSpec", "make_mesh", "rebucket_worker_array",
           "jit_sharded_step", "GradientSharingAccumulator",
           "ParallelWrapper", "ParallelInference",
           "EncodedGradientsAccumulator", "EncodingHandler", "LoopbackBus",
           "threshold_decode", "threshold_encode", "topk_decode",
           "topk_encode", "dot_product_attention"]
