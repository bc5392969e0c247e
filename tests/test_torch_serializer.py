"""The layers' and configurations' JSON, the model serializer and
``CheckpointListener`` against the JAX package (CPU).

- JSON: every layer kind's ``to_json`` dict equals JAX's for the same
  configuration, before and after ``init``; a configuration's JSON
  goes JAX -> port -> JSON unchanged, and the other way.
- Checkpoints across packages: JAX writes after 2 ``fit`` steps and the
  port restores (and the other way); ``output`` then matches within
  1e-5 and one more step on each side within 1e-5 on the loss and
  1e-4 of a leaf's max on the params (f32 GEMMs summed in another
  order, one Adam step). The archive's npz key sets and ``meta.json``'s
  keys are JAX's, and a port checkpoint resumes bit for bit in the port.
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JMultiLayerConfiguration
from deeplearning4j_tpu.nn.layers import attention as JA
from deeplearning4j_tpu.nn.layers import recurrent as JR
from deeplearning4j_tpu.util import serializer as JS
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.layers import attention as TA
from deeplearning4j_tpu_torch.nn.layers import recurrent as TR
from deeplearning4j_tpu_torch.optimize import CheckpointListener
from deeplearning4j_tpu_torch.util import serializer as TS
from deeplearning4j_tpu_torch.util.serializer import (CheckpointFormatError,
                                                      ModelSerializer)

OUT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4

JSIDE = (JL, JR, JA)
TSIDE = (TL, TR, TA)

#: every layer kind the port has, built the same way on both sides
LAYERS = {
    "dense": lambda L, R, A: L.DenseLayer(n_out=4, activation="relu",
                                          l2=0.1, dropout=0.2),
    "output": lambda L, R, A: L.OutputLayer(n_out=3, loss="mse"),
    "loss": lambda L, R, A: L.LossLayer(loss="mse"),
    "activation": lambda L, R, A: L.ActivationLayer(activation="tanh"),
    "dropoutlayer": lambda L, R, A: L.DropoutLayer(0.3),
    "conv2d": lambda L, R, A: L.ConvolutionLayer(
        n_out=4, kernel=(3, 2), stride=(2, 1), padding=((1, 0), (0, 1)),
        dilation=(1, 2), groups=1),
    "subsampling": lambda L, R, A: L.SubsamplingLayer(pooling="pnorm",
                                                      pnorm=3),
    "batchnorm": lambda L, R, A: L.BatchNormalization(decay=0.8,
                                                      lock_gamma_beta=True),
    "embedding": lambda L, R, A: L.EmbeddingLayer(n_in=5, n_out=3,
                                                  has_bias=True),
    "globalpool": lambda L, R, A: L.GlobalPoolingLayer(pooling="max",
                                                       keep_dims=True),
    "lrn": lambda L, R, A: L.LocalResponseNormalization(n=3),
    "zeropad": lambda L, R, A: L.ZeroPaddingLayer(padding=2),
    "upsampling2d": lambda L, R, A: L.Upsampling2D(size=(2, 3)),
    "lstm": lambda L, R, A: R.LSTM(n_out=5, forget_gate_bias_init=0.5),
    "graveslstm": lambda L, R, A: R.GravesLSTM(n_out=5,
                                               gate_activation="hardsigmoid"),
    "gru": lambda L, R, A: R.GRU(n_out=3, reset_after=True),
    "simplernn": lambda L, R, A: R.SimpleRnn(n_out=2, activation="relu"),
    "bidirectional": lambda L, R, A: R.Bidirectional(R.LSTM(n_out=3),
                                                     mode="average"),
    "gravesbidirectionallstm": lambda L, R, A: R.GravesBidirectionalLSTM(
        n_out=4),
    "lasttimestep": lambda L, R, A: R.LastTimeStep(R.SimpleRnn(n_out=3)),
    "maskzero": lambda L, R, A: R.MaskZeroLayer(R.GRU(n_out=3),
                                                mask_value=-1.0),
    "embeddingseq": lambda L, R, A: R.EmbeddingSequenceLayer(n_in=10,
                                                             n_out=4),
    "rnnoutput": lambda L, R, A: R.RnnOutputLayer(n_out=3, loss="mcxent"),
    "rnnloss": lambda L, R, A: R.RnnLossLayer(loss="mse"),
    "repeatvector": lambda L, R, A: R.RepeatVector(n=3),
    "selfattention": lambda L, R, A: A.SelfAttentionLayer(n_heads=2,
                                                          causal=True),
    "transformerencoder": lambda L, R, A: A.TransformerEncoderLayer(
        n_heads=2, d_ff=16, causal=True, implementation="plain"),
}

#: the input each kind is built on (shapes exclude the batch axis)
_INPUT = {"conv2d": (8, 8, 3), "subsampling": (8, 8, 3),
          "lrn": (8, 8, 3), "zeropad": (8, 8, 3), "upsampling2d": (8, 8, 3),
          "embedding": (1,), "embeddingseq": (6,), "repeatvector": (4,),
          "dense": (4,), "output": (4,), "loss": (4,), "activation": (4,),
          "dropoutlayer": (4,), "batchnorm": (4,), "globalpool": (6, 4)}


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_json_equals_jax(kind):
    """The port's dict equals JAX's key for key, before and after
    ``build`` (which fills n_in, the defaults and the wrapped layer's),
    and each package's dict rebuilds the same layer in the other."""
    j, t = LAYERS[kind](*JSIDE), LAYERS[kind](*TSIDE)
    assert t.kind == kind
    assert t.to_json() == j.to_json()
    defaults = {"weight_init": "relu", "activation": "tanh", "l1": 0.01,
                "updater": JAdam(2e-3)}
    shape = _INPUT.get(kind, (6, 4))
    j.build(shape, defaults)
    t.build(shape, dict(defaults, updater=Adam(2e-3)))
    assert t.to_json() == j.to_json()
    assert TL.from_json(j.to_json()).to_json() == j.to_json()
    assert JL.from_json(t.to_json()).to_json() == t.to_json()


def _conf(side, tbptt=0):
    L, R, A = JSIDE if side == 0 else TSIDE
    Conf, Opt = (JConf, JAdam) if side == 0 else (NeuralNetConfiguration,
                                                   Adam)
    b = (Conf.builder().seed(3).updater(Opt(1e-2)).weight_init("xavier")
         .l2(1e-4).dropout(0.1).remat(True)
         .gradient_normalization(max_norm=5.0).list()
         .layer(R.LSTM(n_out=6))
         .layer(A.SelfAttentionLayer(n_heads=2, implementation="plain"))
         .layer(L.DenseLayer(n_out=5, activation="relu"))
         .layer(R.RnnOutputLayer(n_out=3, loss="mcxent")))
    if tbptt:
        b = b.tbptt(tbptt)
    return b.input_type_recurrent(4, 9).build()


def test_configuration_json_round_trips_across_packages():
    jtext, ttext = _conf(0, 3).to_json(), _conf(1, 3).to_json()
    assert json.loads(ttext) == json.loads(jtext)
    # JAX -> port -> JSON and port -> JAX -> JSON, unchanged
    assert MultiLayerConfiguration.from_json(jtext).to_json() == jtext
    assert JMultiLayerConfiguration.from_json(ttext).to_json() == ttext
    # after init (every layer built) too
    jn = JNet(_conf(0)).init()
    tn = MultiLayerNetwork(_conf(1), device="cpu").init()
    assert json.loads(tn.conf.to_json()) == json.loads(jn.conf.to_json())
    c = MultiLayerConfiguration.from_json(jn.conf.to_json())
    assert (c.remat, c.tbptt_fwd_length, c.max_grad_norm) == (True, 0, 5.0)


def _mlp_conf(side):
    L = JL if side == 0 else TL
    Conf, Opt = (JConf, JAdam) if side == 0 else (NeuralNetConfiguration,
                                                   Adam)
    return (Conf.builder().seed(11).updater(Opt(1e-2)).weight_init("xavier")
            .list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.BatchNormalization())
            .layer(L.DropoutLayer(0.2))
            .layer(L.OutputLayer(n_out=3, loss="mcxent"))
            .input_type_feed_forward(5).build())


def _data(seed=0, n=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 5).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 1] > 1).astype(int)]
    return x, y


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_trees_close(jtree, ttree, tol=PARAM_TOL):
    jflat, tflat = JS._flatten_tree(jtree), TS._flatten_tree(ttree)
    assert sorted(jflat) == sorted(tflat)
    for k, ref in jflat.items():
        err = np.abs(tflat[k] - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= tol, (k, err)


def _members(path):
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
        keys = {n: sorted(np.load(z.open(n)).files) for n in names
                if n.endswith(".npz")}
        meta = json.loads(z.read("meta.json"))
    return names, keys, meta


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    x, y = _data()
    jn = JNet(_mlp_conf(0)).init()
    for _ in range(2):
        jn.fit(x, y)
    path = str(tmp_path / "jax.zip")
    JS.ModelSerializer.write_model(jn, path)
    tn = ModelSerializer.restore(path, device="cpu")
    assert tn._step == jn._step == 2
    assert [int(v) for v in tn._rng] == np.asarray(jn._rng).tolist()
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               rtol=0, atol=OUT_ATOL)
    jn.fit(x, y)
    tn.fit(x, y)
    assert tn.score_ == pytest.approx(float(jn.score_), rel=LOSS_RTOL)
    _assert_trees_close(jn.params(), tn.params())
    _assert_trees_close(jn._net_state, tn.get_net_state(), 1e-5)
    _assert_trees_close(jn.get_updater_state(), tn.get_updater_state())


def test_port_checkpoint_restores_in_jax(tmp_path):
    x, y = _data(1)
    jn = JNet(_mlp_conf(0)).init()
    tn = MultiLayerNetwork(_mlp_conf(1), device="cpu").init()
    tn.set_params(network_params_from_jax(jax.tree.map(np.asarray,
                                                       jn.params())))
    for _ in range(2):
        tn.fit(x, y)
    tpath, jpath = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    ModelSerializer.write_model(tn, tpath, normalizer={"mean": [0.5]})
    for _ in range(2):
        jn.fit(x, y)
    JS.ModelSerializer.write_model(jn, jpath, normalizer={"mean": [0.5]})
    # the same members, npz keys and meta keys as JAX's archive
    tnames, tkeys, tmeta = _members(tpath)
    jnames, jkeys, jmeta = _members(jpath)
    assert (tnames, tkeys, sorted(tmeta)) == (jnames, jkeys, sorted(jmeta))
    assert tmeta["format_version"] == 2 and tmeta["rng"] == jmeta["rng"]
    for name, keys in tkeys.items():
        with zipfile.ZipFile(tpath) as zt, zipfile.ZipFile(jpath) as zj:
            t, j = np.load(zt.open(name)), np.load(zj.open(name))
            assert all(t[k].dtype == j[k].dtype for k in keys)
    jr = JS.ModelSerializer.restore(tpath)
    assert JS.ModelSerializer.restore_normalizer(tpath) == {"mean": [0.5]}
    assert ModelSerializer.restore_normalizer(jpath) == {"mean": [0.5]}
    np.testing.assert_allclose(np.asarray(jr.output(x)), _np(tn.output(x)),
                               rtol=0, atol=OUT_ATOL)
    jr.fit(x, y)
    tn.fit(x, y)
    assert tn.score_ == pytest.approx(float(jr.score_), rel=LOSS_RTOL)
    _assert_trees_close(jr.params(), tn.params())


def test_port_checkpoint_resumes_bit_for_bit(tmp_path):
    """Restore after 2 steps, then 2 more steps on the restored network
    and the uninterrupted one: the same bits (dropout keys included)."""
    x, y = _data(2)
    a = MultiLayerNetwork(_mlp_conf(1), device="cpu").init()
    for _ in range(2):
        a.fit(x, y)
    path = str(tmp_path / "a.zip")
    ModelSerializer.write_model(a, path)
    b = ModelSerializer.restore(path, device="cpu")
    for _ in range(2):
        a.fit(x, y)
        b.fit(x, y)
        assert float(a.score_) == float(b.score_)
    for tree_a, tree_b in ((a.params(), b.params()),
                           (a.get_updater_state(), b.get_updater_state()),
                           (a.get_net_state(), b.get_net_state())):
        fa, fb = TS._flatten_tree(tree_a), TS._flatten_tree(tree_b)
        assert sorted(fa) == sorted(fb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    fresh = ModelSerializer.restore(path, load_updater=False, device="cpu")
    assert all(not t.any() for st in fresh.get_updater_state().values()
               for part in st.values() for t in part.values())


def test_unknown_format_version_raises(tmp_path):
    tn = MultiLayerNetwork(_mlp_conf(1), device="cpu").init()
    path = str(tmp_path / "future.zip")
    snap = TS.snapshot_training_state(tn, cursor={"epoch": 0, "batch": 3})
    snap["meta"]["format_version"] = 9
    ModelSerializer.write_snapshot(snap, path)
    for restore in (ModelSerializer.restore, JS.ModelSerializer.restore):
        with pytest.raises(CheckpointFormatError if restore is
                           ModelSerializer.restore else
                           JS.CheckpointFormatError) as e:
            restore(path)
        assert e.value.found == 9 and e.value.path == path
    with pytest.raises(CheckpointFormatError):
        ModelSerializer.validate_format(str(tmp_path))   # no manifest
    snap["meta"]["format_version"] = 2
    ModelSerializer.write_snapshot(snap, path)
    assert ModelSerializer.validate_format(path) == 2
    assert ModelSerializer.restore(path, device="cpu")._resume_cursor == \
        {"epoch": 0, "batch": 3}


def test_shard_functions_round_trip_bit_for_bit(tmp_path):
    x, y = _data(3)
    tn = MultiLayerNetwork(_mlp_conf(1), device="cpu").init()
    tn.fit(x, y)
    rs = np.random.RandomState(0)
    extra = {"residual": rs.randn(3, 4).astype(np.float32),
             "threshold": np.float32(0.5) * np.ones(2, np.float32)}
    snap = TS.snapshot_training_state(tn, extra=extra)
    shards, manifest = TS.shard_training_snapshot(snap, 3)
    jshards, jmanifest = JS.shard_training_snapshot(snap, 3)
    assert manifest == jmanifest
    d = tmp_path / "ckpt"
    d.mkdir()
    for i, sh in enumerate(shards):
        TS.write_shard(sh, str(d / TS.shard_name(i)))
        assert sorted(sh) == sorted(jshards[i])
    with open(d / TS.MANIFEST_NAME, "w") as f:
        json.dump(manifest, f)
    back = TS.merge_shard_snapshots(
        TS.read_manifest(str(d)),
        [TS.read_shard(str(d / TS.shard_name(i))) for i in range(3)])
    assert back["conf_json"] == snap["conf_json"]
    assert back["meta"]["step"] == snap["meta"]["step"]
    for section in ("params", "net_state", "opt_state", "extra"):
        assert sorted(back[section]) == sorted(snap[section])
        for k, v in snap[section].items():
            assert back[section][k].dtype == v.dtype
            assert np.array_equal(back[section][k], v)
    r = ModelSerializer.restore(str(d), device="cpu")
    assert np.array_equal(r._resume_extra["residual"], extra["residual"])
    np.testing.assert_array_equal(_np(r.output(x)), _np(tn.output(x)))
    with pytest.raises(CheckpointFormatError):
        TS.merge_shard_snapshots(TS.read_manifest(str(d)), [])
    # the model type recorded picks the class: a graph's configuration
    # rebuilds a ComputationGraph
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import InputType
    gconf = (NeuralNetConfiguration.builder().seed(1).graph_builder()
             .add_inputs("in").set_input_types(InputType.feed_forward(4))
             .add_layer("out", TL.OutputLayer(n_out=2), "in")
             .set_outputs("out").build())
    g = ModelSerializer._model_from_conf(gconf.to_json(), "ComputationGraph",
                                         "cpu")
    assert isinstance(g, ComputationGraph) and g.num_params() == 10


def test_checkpoint_listener_saves_and_keeps_last(tmp_path):
    x, y = _data(4)
    tn = MultiLayerNetwork(_mlp_conf(1), device="cpu").init()
    d = str(tmp_path / "ckpts")
    lst = CheckpointListener(d, save_every_n_iterations=2,
                             save_every_n_epochs=3, keep_last=2)
    tn.set_listeners(lst)
    tn.fit([(x, y)] * 3, epochs=3)      # 9 iterations, 3 epochs
    assert sorted(os.listdir(d)) == ["checkpoint_epoch_3.zip",
                                     "checkpoint_iter_8.zip"]
    assert lst.last_checkpoint() == os.path.join(d,
                                                 "checkpoint_epoch_3.zip")
    r = ModelSerializer.restore(lst.last_checkpoint(), device="cpu")
    assert (r._step, r._epoch) == (9, 3)
    np.testing.assert_array_equal(_np(r.output(x)), _np(tn.output(x)))


def test_clone_goes_through_json():
    tn = MultiLayerNetwork(_conf(1), device="cpu").init()
    x = np.random.RandomState(5).randn(2, 9, 4).astype(np.float32)
    c = tn.clone()
    assert c.conf is not tn.conf and c.conf.layers[0] is not \
        tn.conf.layers[0]
    assert c.conf.to_json() == tn.conf.to_json()
    np.testing.assert_array_equal(_np(c.output(x)), _np(tn.output(x)))


def test_bf16_leaves_cross_packages_and_archives(tmp_path):
    """bf16 leaves: ``convert.py`` takes JAX's ``ml_dtypes.bfloat16``
    arrays (bits through an int16 view, no ``ml_dtypes`` import), the
    serializer writes each bf16 leaf as the npz member bytes JAX's
    ``np.savez`` writes (a ``<V2`` header over the same bits), and a
    ``|V2`` member reads back as bf16, bit for bit, also where the
    template leaf is f32."""
    import io

    import jax.numpy as jnp
    tree = {"layer_0": {"W": np.asarray(jnp.asarray(
        np.random.RandomState(0).randn(3, 5), jnp.bfloat16)),
        "b": np.asarray(jnp.zeros((5,), jnp.bfloat16))}}
    t = network_params_from_jax(tree)
    for n, v in tree["layer_0"].items():
        assert t["layer_0"][n].dtype == torch.bfloat16
        assert np.array_equal(t["layer_0"][n].view(torch.int16).numpy(),
                              v.view(np.int16))
    jbuf = io.BytesIO()
    np.savez(jbuf, **{f"layer_0/{n}": v for n, v in tree["layer_0"].items()})
    flat = TS._flatten_tree(t)
    port = TS._npz_bytes(flat)
    with zipfile.ZipFile(io.BytesIO(jbuf.getvalue())) as jz, \
            zipfile.ZipFile(io.BytesIO(port)) as tz:
        assert jz.namelist() == tz.namelist()
        for n in jz.namelist():
            assert jz.read(n) == tz.read(n), n
    loaded = dict(np.load(io.BytesIO(port)))
    assert all(v.dtype.kind == "V" for v in loaded.values())
    template = {"layer_0": {"W": torch.zeros(3, 5),
                            "b": torch.zeros(5, dtype=torch.bfloat16)}}
    back = TS._unflatten_like(template, loaded)
    for n in ("W", "b"):
        assert back["layer_0"][n].dtype == torch.bfloat16
        assert torch.equal(back["layer_0"][n], t["layer_0"][n])
