"""What the port's data-parallel CPU test ranks run
(``tests/_torch_dp_worker.py``), and the networks and data both sides
build. Nothing here imports JAX: the test files build the same
configurations from the JAX package's classes (``conf(side, ...)``
takes either package's ``NeuralNetConfiguration``, layers and
updaters), carry JAX's initial weights to the ranks through
``inputs.npz``, and compare the ranks' ``rank<r>_<case>.npz`` with
the JAX package's runs of the same cases.

A case's arrays are stored under flat keys: ``params/...``,
``opt/...`` (the model's updater state), ``net/...`` (layer state),
``extra/...`` (the wrapper's gathered ``gradient_sharing/...`` state),
``loss`` and ``ok`` (one entry a step), and ``telemetry`` (JSON text).
"""
import json
import os

import numpy as np

#: the cases of tests/test_torch_parallel.py: (name, accumulator mode or
#: None for the dense step, guarded, per-sample mask, NaN batch or None)
STEP_CASES = (
    ("dense", None, False, False, None),
    ("dense_guard", None, True, False, 1),
    ("dense_mask", None, False, True, None),
    ("update", "update", False, False, None),
    ("update_guard", "update", True, False, 1),
    ("gradient", "gradient", False, False, None),
    ("gradient_guard", "gradient", True, True, 1),
)
#: the cases driven through ParallelWrapper.fit instead of the step
FIT_CASES = (("fit_dense", None), ("fit_update", "update"))
STEPS = 3
BATCH = 16
KEY_SEED = 11


class Side:
    """One package's classes, by the names the configurations use."""

    def __init__(self, conf, layers, adam, sgd):
        self.Conf, self.L, self.Adam, self.Sgd = conf, layers, adam, sgd


def port_side() -> Side:
    from deeplearning4j_tpu_torch.learning import Adam, Sgd
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration, layers
    return Side(NeuralNetConfiguration, layers, Adam, Sgd)


def bn_conf(side: Side, seed: int = 7):
    """Batch norm behind a bias-free dense layer, dropout on two layer
    inputs, Adam: the net whose dense step must see the global batch."""
    L = side.L
    return (side.Conf.builder().seed(seed).updater(side.Adam(1e-2))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=16, activation="identity",
                                has_bias=False))
            .layer(L.BatchNormalization(activation="tanh"))
            .layer(L.DenseLayer(n_out=8, activation="relu", dropout=0.2))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax", dropout=0.1))
            .input_type_feed_forward(4).build())


def mlp_conf(side: Side, seed: int = 7, adam: bool = False):
    """The MLP of tests/test_multihost_training.py (Sgd(0.1)), or with
    Adam(1e-2)."""
    L = side.L
    opt = side.Adam(1e-2) if adam else side.Sgd(0.1)
    return (side.Conf.builder().seed(seed).updater(opt)
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .input_type_feed_forward(4).build())


def batches(n: int = STEPS, batch: int = BATCH, seed: int = 0,
            mask: bool = False, nan_batch=None):
    """``n`` global batches (x, y, mask) of ``batch`` rows. The mask
    keeps 6 of the first half's rows and 2 of the second's, so a mean
    of the two halves' means is not the global mean; ``nan_batch``
    poisons one row of the second half of that batch."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(n * batch, 4) * 2 - 1).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[((x[:, 0] * x[:, 1] + x[:, 2]) > 0)
                                    .astype(int)]
    out = []
    for i in range(n):
        xb, yb = x[i * batch:(i + 1) * batch].copy(), \
            y[i * batch:(i + 1) * batch]
        m = None
        if mask:
            half = batch // 2
            m = np.zeros(batch, np.float32)
            m[:half][:6] = 1.0
            m[half:][-2:] = 1.0
        if nan_batch == i:
            xb[batch - 3, 1] = np.nan
        out.append((xb, yb, m))
    return out


def flat_tree(tree, prefix=""):
    """{"a/b": host array} in the checkpoint's order and spelling."""
    from deeplearning4j_tpu_torch.util.serializer import _flatten_tree
    return {f"{prefix}{k}": v for k, v in _flatten_tree(tree).items()}


def nested(flat):
    """A flat {"layer_0/W": array} dict as {"layer_0": {"W": array}}."""
    out = {}
    for k, v in flat.items():
        key, name = k.split("/", 1)
        out.setdefault(key, {})[name] = v
    return out


def load_inputs(outdir):
    with np.load(os.path.join(outdir, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


def port_net(conf, init_flat):
    """The port's network on the CPU from JAX's initial weights."""
    from deeplearning4j_tpu_torch.convert import network_params_from_jax
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    m = MultiLayerNetwork(conf, device="cpu").init()
    m.set_params(network_params_from_jax(nested(init_flat)))
    return m


def init_of(inputs, name):
    pre = f"init_{name}/"
    return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}


def save(outdir, rank, case, arrays, telemetry=None):
    arrays = dict(arrays)
    if telemetry is not None:
        arrays["telemetry"] = np.array(json.dumps(telemetry,
                                                  sort_keys=True))
    np.savez(os.path.join(outdir, f"rank{rank}_{case}.npz"), **arrays)


def state_arrays(m, pw=None):
    out = {}
    out.update(flat_tree(m._params, "params/"))
    out.update(flat_tree(m._opt_state, "opt/"))
    out.update(flat_tree(m._net_state, "net/"))
    if pw is not None:
        extra = pw.extra_checkpoint_state() or {}
        out.update({f"extra/{k}": v for k, v in extra.items()})
    return out


# -- tests/test_torch_parallel.py --------------------------------------
def parallel_cases(rank, world, outdir):
    import torch
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelInference, ParallelWrapper,
        make_mesh)
    inputs = load_inputs(outdir)
    side = port_side()
    # the mesh: every rank on the data axis; a 3 x 3 grid refused; the
    # model axis; a wrapper over the first worker only
    mesh = make_mesh()
    try:
        make_mesh(data=3, model=3)
        refused = False
    except ValueError:
        refused = True
    m2 = make_mesh(data=1, model=world)
    one = port_net(bn_conf(side), init_of(inputs, "bn"))
    try:
        solo = ParallelWrapper(one, workers=1).num_workers
    except ValueError:
        solo = -1
    save(outdir, rank, "mesh", {}, dict(
        shape=mesh.shape, coords=list(mesh.coords), refused=refused,
        model_shape=m2.shape, model_coords=list(m2.coords), solo=solo))

    for name, mode, guard, masked, nan in STEP_CASES:
        m = port_net(bn_conf(side), init_of(inputs, "bn"))
        acc = None if mode is None else GradientSharingAccumulator(
            mode=mode)
        pw = ParallelWrapper(m, prefetch_buffer=0, accumulator=acc)
        step = pw.ensure_step(guard=guard)
        key = R.PRNGKey(KEY_SEED)
        losses, oks = [], []
        params, opt, net = m._params, m._opt_state, m._net_state
        for i, (x, y, msk) in enumerate(batches(mask=masked,
                                                nan_batch=nan)):
            keys = R.split(key)
            key, sub = R.key_at(keys, 0), R.key_at(keys, 1)
            out = step(params, opt, net, i, torch.from_numpy(x),
                       torch.from_numpy(y),
                       None if msk is None else torch.from_numpy(msk), sub)
            params, opt, net, loss = out[:4]
            losses.append(float(loss))
            oks.append(bool(out[4]) if guard else True)
        m._params, m._opt_state, m._net_state = params, opt, net
        arrays = state_arrays(m, pw)
        arrays["loss"] = np.array(losses, np.float32)
        arrays["ok"] = np.array(oks)
        save(outdir, rank, name, arrays,
             pw.telemetry_snapshot() if mode else None)

    for name, mode in FIT_CASES:
        m = port_net(bn_conf(side), init_of(inputs, "bn"))
        acc = None if mode is None else GradientSharingAccumulator(
            mode=mode)
        pw = ParallelWrapper(m, prefetch_buffer=0, accumulator=acc)
        losses = []
        for x, y, _ in batches():
            pw.fit([(x, y)], epochs=1)
            losses.append(m.score_)
        arrays = state_arrays(m, pw)
        arrays["loss"] = np.array(losses, np.float32)
        save(outdir, rank, name, arrays)

    m = port_net(bn_conf(side), init_of(inputs, "bn_trained"))
    m.set_net_state({"layer_1": {
        "mean": torch.from_numpy(inputs["bn_trained_mean"]),
        "var": torch.from_numpy(inputs["bn_trained_var"])}})
    x = batches()[0][0]
    save(outdir, rank, "inference", {
        "out": ParallelInference(m).output(x).numpy(),
        "plain": m.output(x).numpy()})


# -- tests/test_torch_multihost.py -------------------------------------
def global_data(n=16, seed=0):
    """The global batch of tests/test_multihost_training.py."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(n, 4) * 2 - 1).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(-1) > 0).astype(int)]


def multihost_cases(rank, world, outdir):
    import torch.distributed as dist
    from deeplearning4j_tpu_torch import random as R
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, Mesh, ParallelWrapper, PartitionSpec)
    from deeplearning4j_tpu_torch.parallel.elastic import initialize_cluster
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostIterator, build_multihost_step, global_mesh,
        host_local_array, replicated_array)
    inputs = load_inputs(outdir)
    side = port_side()
    save(outdir, rank, "cluster", {}, dict(
        world=dist.get_world_size(), rank=dist.get_rank(),
        backend=str(dist.get_backend()),
        noop=initialize_cluster(num_processes=1)))

    # one dense step over the cross-process mesh from local shards
    X, Y = global_data()
    lo = rank * 8
    m = port_net(mlp_conf(side), init_of(inputs, "mlp"))
    mesh = global_mesh()
    step = build_multihost_step(m, mesh)
    x = host_local_array(mesh, PartitionSpec("data"), X[lo:lo + 8])
    y = host_local_array(mesh, PartitionSpec("data"), Y[lo:lo + 8])
    params = replicated_array(mesh, m._params)
    opt = replicated_array(mesh, m._opt_state)
    net = replicated_array(mesh, m._net_state)
    rng = R.PRNGKey(0)
    losses = []
    for i in range(4):
        params, opt, net, loss = step(params, opt, net, i, x, y, None, rng)
        losses.append(float(loss))
    m._params = params
    save(outdir, rank, "step", dict(flat_tree(params, "params/"),
                                    loss=np.array(losses, np.float32)),
         dict(global_shape=list(x.shape), local_rows=int(x.local.shape[0])))

    # the compressed step over a (2, 1) mesh, fed local shards
    m = port_net(mlp_conf(side, adam=True), init_of(inputs, "mlp_adam"))
    mesh = Mesh(np.arange(world).reshape(world, 1), ("data", "model"))
    pw = ParallelWrapper(m, mesh=mesh, prefetch_buffer=0,
                         accumulator=GradientSharingAccumulator(
                             threshold=1e-3))
    pw._build_step()
    params = replicated_array(mesh, m._params)
    opt = replicated_array(mesh, m._opt_state)
    net = replicated_array(mesh, m._net_state)
    losses = []
    for i in range(4):
        params, opt, net, loss = pw._sharded_step(params, opt, net, i, x,
                                                  y, None, rng)
        losses.append(float(loss))
    m._params = params
    save(outdir, rank, "comp", dict(state_arrays(m, pw),
                                    loss=np.array(losses, np.float32)))

    # the user API: fit on each process's rows of every global batch of
    # 16 (batch k is rows [16k, 16k + 16); process p owns rows
    # [16k + 8p, 16k + 8p + 8)), wrapped by MultiHostIterator
    X, Y = global_data(32)
    rows = np.concatenate([np.arange(16 * k + 8 * rank,
                                     16 * k + 8 * (rank + 1))
                           for k in range(2)])
    it = ArrayDataSetIterator(X[rows], Y[rows], batch=8, shuffle=False)
    m = port_net(mlp_conf(side), init_of(inputs, "mlp"))
    pw = ParallelWrapper(m, mesh=global_mesh(), prefetch_buffer=0)
    losses = []
    for _ in range(3):
        pw.fit(it, epochs=1)
        losses.append(m.score_)
    wrapped = MultiHostIterator(it, pw.mesh)
    first = next(iter(wrapped))
    save(outdir, rank, "fit", dict(flat_tree(m._params, "params/"),
                                   loss=np.array(losses, np.float32)),
         dict(batch_size=wrapped.batch_size(),
              item_global=[list(v.global_shape) for v in first],
              item_local=[list(v.local.shape) for v in first]))


# -- tests/test_torch_elastic.py: the wrapper mode -----------------------
ELASTIC_MODES = ("plain", "update", "gradient")
PREEMPT_AT = 7


def elastic_conf(side):
    """tests/test_torch_elastic.py's MLP (Adam(1e-2), seed 0)."""
    L = side.L
    return (side.Conf.builder().seed(0).updater(side.Adam(1e-2))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax"))
            .input_type_feed_forward(4).build())


def elastic_arrays(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 4).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]


def elastic_wrapper(model, mode, workers=None):
    from deeplearning4j_tpu_torch.parallel import (
        GradientSharingAccumulator, ParallelWrapper)
    acc = None if mode == "plain" else GradientSharingAccumulator(mode=mode)
    return ParallelWrapper(model, workers=workers, accumulator=acc)


def elastic_cases(rank, world, outdir):
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.faults import (FaultInjector,
                                                 PreemptionFault)
    from deeplearning4j_tpu_torch.parallel.elastic import \
        FaultTolerantTrainer as FT
    inputs = load_inputs(outdir)
    side = port_side()
    X, Y = elastic_arrays()

    def it():
        return ArrayDataSetIterator(X, Y, batch=16, shuffle=True, seed=3)

    def trainer(m, d, mode, **kw):
        return FT(m, d, save_every_n_steps=3,
                  wrapper=elastic_wrapper(m, mode),
                  sharded_checkpoints=True, **kw)

    # the same-shape kill and resume, bit for bit, in each mode
    for mode in ELASTIC_MODES:
        base = os.path.join(outdir, f"port_{mode}")
        a = port_net(elastic_conf(side), init_of(inputs, "elastic"))
        trainer(a, f"{base}_a", mode).fit(it(), epochs=3)
        b = port_net(elastic_conf(side), init_of(inputs, "elastic"))
        try:
            trainer(b, f"{base}_b", mode, fault_injector=FaultInjector(
                plan={"preempt": [PREEMPT_AT]})).fit(it(), epochs=3)
            raise AssertionError("not preempted")
        except PreemptionFault:
            pass
        preempted = state_arrays(b)
        # the restart resumes B's archive and writes its own, so B's
        # stays the preempted one for the tests to restore
        c = FT.resume(f"{base}_b", device="cpu")
        resumed_step = c._step
        tc = trainer(c, f"{base}_c", mode)
        tc.fit(it(), epochs=3)
        pw = tc.wrapper
        save(outdir, rank, f"elastic_{mode}", dict(
            {f"a/{k}": v for k, v in state_arrays(a).items()},
            **{f"c/{k}": v for k, v in state_arrays(c, pw).items()},
            **{f"b/{k}": v for k, v in preempted.items()}),
            dict(resumed_step=resumed_step, steps=[a._step, c._step],
                 remesh=pw.last_remesh, writes=pw.writes_checkpoints,
                 telemetry=tc.telemetry_snapshot()["wrapper"]))

    # JAX's W-worker archive (update mode, preempted at step 7) resumed
    # at the same worker count: the restored state, then the rest of the
    # schedule
    jdir = os.path.join(outdir, "jax_update")
    m = FT.resume(jdir, device="cpu")
    tr = trainer(m, jdir + "_port", "update")
    pw = tr.wrapper
    pw.ensure_step()
    restored = state_arrays(m, pw)
    tr.fit(it(), epochs=3)
    save(outdir, rank, "jax_resumed", dict(
        {f"restored/{k}": v for k, v in restored.items()},
        **{f"final/{k}": v for k, v in state_arrays(m, pw).items()}),
        dict(step=m._step, remesh=pw.last_remesh))
