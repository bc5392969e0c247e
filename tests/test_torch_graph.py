"""ComputationGraph of the port against the JAX package's (CPU).

The same configuration is built in both packages from seeded numpy
inputs. Tolerances, each with its reason:

- vertices: 0 (the same f32 op), L2 and L2Normalize within 1e-6 of the
  largest value (a sum over the row in another order);
- ``init`` from one seed: uniform draws bit for bit, normal ones within
  3 f32 ulp (``random.normal``, XLA's erf_inv with its own log1p);
- forward outputs: 1e-5 absolute (f32 GEMMs summed in another order);
- training (JAX's params carried across, 3 Adam steps with clipping):
  losses within 1e-5 relative and every param within 1e-4 of its leaf's
  largest |value|, the serializer tests' tolerance;
- the bf16 policy: the first loss within 1e-2 relative and each SGD
  update within 4e-2 of its leaf's largest update (both round
  activations to bf16, at other places; the multilayer bf16 tests'
  gradient tolerance);
- remat and a resumed archive: bit for bit.
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.learning as JU
import deeplearning4j_tpu.nn as JN
import deeplearning4j_tpu.nn.conf as JC
import deeplearning4j_tpu.nn.graph as JG
import deeplearning4j_tpu.nn.layers as JL
import deeplearning4j_tpu.nn.layers.recurrent as JR
from deeplearning4j_tpu.util.serializer import ModelSerializer as JSer
import deeplearning4j_tpu_torch.learning as TU
import deeplearning4j_tpu_torch.nn as TN
import deeplearning4j_tpu_torch.nn.conf as TC
import deeplearning4j_tpu_torch.nn.graph as TG
import deeplearning4j_tpu_torch.nn.layers as TL
import deeplearning4j_tpu_torch.nn.layers.recurrent as TR
from deeplearning4j_tpu_torch.convert import (graph_params_from_jax,
                                              graph_state_from_jax,
                                              graph_updater_state_from_jax)
from deeplearning4j_tpu_torch.serving.engine import (ClientError,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.util import serializer as TS
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

OUT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
BF16_LOSS_RTOL = 1e-2
BF16_UPDATE_TOL = 4e-2


class _Side:
    def __init__(self, U, N, C, G, L, R):
        self.U, self.N, self.C, self.G, self.L, self.R = U, N, C, G, L, R


J = _Side(JU, JN, JC, JG, JL, JR)
T = _Side(TU, TN, TC, TG, TL, TR)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


# -- the graphs of tests/test_computation_graph.py, with clipping -----------

def residual_mlp(S, seed=1, clip=True):
    b = S.N.NeuralNetConfiguration.builder().seed(seed).updater(
        S.U.Adam(1e-2)).weight_init("xavier")
    if clip:
        b = b.gradient_normalization(max_norm=0.5, clip_value=0.2)
    return (b.graph_builder()
            .add_inputs("in")
            .set_input_types(S.C.InputType.feed_forward(4))
            .add_layer("d1", S.L.DenseLayer(n_out=4, activation="relu"), "in")
            .add_layer("d2", S.L.DenseLayer(n_out=4, activation="relu"), "d1")
            .add_vertex("res", S.G.ElementWiseVertex("add"), "d1", "d2")
            .add_layer("out", S.L.OutputLayer(n_out=2), "res")
            .set_outputs("out")
            .build())


def multi_io(S):
    return (S.N.NeuralNetConfiguration.builder().seed(3)
            .updater(S.U.Adam(1e-2))
            .gradient_normalization(max_norm=1.0)
            .graph_builder()
            .add_inputs("a", "b")
            .set_input_types(S.C.InputType.feed_forward(3),
                             S.C.InputType.feed_forward(5))
            .add_layer("da", S.L.DenseLayer(n_out=4, activation="tanh"), "a")
            .add_layer("db", S.L.DenseLayer(n_out=4, activation="tanh"), "b")
            .add_vertex("m", S.G.MergeVertex(), "da", "db")
            .add_layer("out1", S.L.OutputLayer(n_out=2), "m")
            .add_layer("out2", S.L.OutputLayer(n_out=3), "m")
            .set_outputs("out1", "out2")
            .build())


def cnn_graph(S):
    return (S.N.NeuralNetConfiguration.builder().seed(5)
            .updater(S.U.Adam(1e-3))
            .gradient_normalization(clip_value=0.5)
            .graph_builder()
            .add_inputs("img")
            .set_input_types(S.C.InputType.convolutional(8, 8, 1))
            .add_layer("c1", S.L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                                  activation="relu"), "img")
            .add_layer("p1", S.L.SubsamplingLayer(kernel=(2, 2),
                                                  stride=(2, 2)), "c1")
            .add_vertex("flat", S.G.PreprocessorVertex("cnn_to_ff"), "p1")
            .add_layer("out", S.L.OutputLayer(n_out=3), "flat")
            .set_outputs("out")
            .build())


def siamese(S):
    return (S.N.NeuralNetConfiguration.builder().seed(7)
            .updater(S.U.Adam(1e-2))
            .gradient_normalization(max_norm=2.0, clip_value=1.0)
            .graph_builder()
            .add_inputs("x1", "x2")
            .set_input_types(S.C.InputType.feed_forward(4),
                             S.C.InputType.feed_forward(4))
            .add_vertex("stack", S.G.StackVertex(), "x1", "x2")
            .add_layer("tower", S.L.DenseLayer(n_out=6, activation="tanh"),
                       "stack")
            .add_vertex("e1", S.G.UnstackVertex(0, 2), "tower")
            .add_vertex("e2", S.G.UnstackVertex(1, 2), "tower")
            .add_vertex("dist", S.G.L2Vertex(), "e1", "e2")
            .add_layer("out", S.L.OutputLayer(n_out=2, activation="softmax"),
                       "dist")
            .set_outputs("out")
            .build())


def _data(name, n=8, seed=0):
    rs = np.random.RandomState(seed)
    if name == "residual":
        x = rs.randn(n, 4).astype(np.float32)
        return x, np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    if name == "multi_io":
        return ([rs.randn(n, 3).astype(np.float32),
                 rs.randn(n, 5).astype(np.float32)],
                [np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)],
                 np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]])
    if name == "cnn":
        return (rs.randn(n, 8, 8, 1).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])
    return ({"x1": rs.randn(n, 4).astype(np.float32),
             "x2": rs.randn(n, 4).astype(np.float32)},
            np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)])


GRAPHS = {"residual": residual_mlp, "multi_io": multi_io, "cnn": cnn_graph,
          "siamese": siamese}


def _pair(build):
    """The JAX graph, and the port's on the CPU with JAX's params, layer
    state and updater state carried across."""
    jg = J.G.ComputationGraph(build(J)).init()
    tg = T.G.ComputationGraph(build(T), device="cpu").init()
    tg.set_params(graph_params_from_jax(jax.tree.map(np.asarray,
                                                     jg.params())))
    tg.set_net_state(graph_state_from_jax(jax.tree.map(
        np.asarray, jg._net_state)))
    tg.set_updater_state(graph_updater_state_from_jax(jax.tree.map(
        np.asarray, jg._opt_state)))
    return jg, tg


def _assert_params_close(jtree, ttree, tol=PARAM_TOL):
    assert set(jtree) == set(ttree)
    for k, p in jtree.items():
        assert set(p) == set(ttree[k]), k
        for n, v in p.items():
            a, b = np.asarray(v, np.float32), _np(ttree[k][n])
            scale = max(float(np.abs(a).max()), 1e-30)
            assert np.abs(a - b).max() <= tol * scale, (k, n)


# -- vertices ----------------------------------------------------------------

VERTICES = {
    "merge": (lambda G: G.MergeVertex(), 2, (2, 3)),
    "add": (lambda G: G.ElementWiseVertex("add"), 3, (2, 3)),
    "product": (lambda G: G.ElementWiseVertex("product"), 3, (2, 3)),
    "subtract": (lambda G: G.ElementWiseVertex("subtract"), 2, (2, 3)),
    "average": (lambda G: G.ElementWiseVertex("average"), 3, (2, 3)),
    "max": (lambda G: G.ElementWiseVertex("max"), 3, (2, 3)),
    "subset": (lambda G: G.SubsetVertex(1, 3), 1, (2, 5)),
    "stack": (lambda G: G.StackVertex(), 2, (2, 3)),
    "unstack": (lambda G: G.UnstackVertex(1, 3), 1, (6, 3)),
    "scale": (lambda G: G.ScaleVertex(0.17), 1, (2, 3)),
    "shift": (lambda G: G.ShiftVertex(-1.5), 1, (2, 3)),
    "l2normalize": (lambda G: G.L2NormalizeVertex(eps=1e-6), 1, (2, 3, 4)),
    "l2": (lambda G: G.L2Vertex(eps=1e-7), 2, (2, 3, 4)),
    "reshape": (lambda G: G.ReshapeVertex((3, 2)), 1, (2, 6)),
    "cnn_to_ff": (lambda G: G.PreprocessorVertex("cnn_to_ff"), 1,
                  (2, 2, 3, 4)),
    "rnn_last_step": (lambda G: G.PreprocessorVertex("rnn_last_step"), 1,
                      (2, 5, 3)),
    "ff_to_rnn": (lambda G: G.PreprocessorVertex("ff_to_rnn"), 1, (2, 3)),
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(name):
    make, n_in, shape = VERTICES[name]
    rs = np.random.RandomState(len(name))
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(n_in)]
    jv, tv = make(JG), make(TG)
    want = np.asarray(jv.apply([jax.numpy.asarray(x) for x in xs]))
    got = tv.apply([torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape
    tol = 1e-6 * np.abs(want).max() if name.startswith("l2") else 0.0
    assert np.abs(got - want).max() <= tol
    in_shapes = [x.shape[1:] for x in xs]
    assert tuple(tv.output_shape(in_shapes)) == tuple(
        jv.output_shape(in_shapes))


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_json_both_ways(name):
    make = VERTICES[name][0]
    jd, td = make(JG).to_json(), make(TG).to_json()
    assert td == jd
    assert TG.vertex_from_json(jd).to_json() == jd
    assert JG.vertex_from_json(td).to_json() == td
    assert set(TG.VERTEX_REGISTRY) == set(JG.VERTEX_REGISTRY)


def test_samediff_lambda_vertex_refused_but_round_trips():
    v = TG.SameDiffLambdaVertex(fn=lambda sd, a: a)
    assert v.to_json() == JG.SameDiffLambdaVertex(fn=None).to_json()
    with pytest.raises(NotImplementedError, match="item 15"):
        v.apply([torch.ones(2, 3)])
    with pytest.raises(ValueError, match="not serializable"):
        TG.vertex_from_json(v.to_json())


# -- configuration -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_configuration_json_key_for_key(name):
    jc, tc = GRAPHS[name](J), GRAPHS[name](T)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    back = T.G.ComputationGraphConfiguration.from_json(jc.to_json())
    assert back.to_json() == jc.to_json()
    there = J.G.ComputationGraphConfiguration.from_json(tc.to_json())
    assert there.to_json() == tc.to_json()


def test_topological_order_and_cycle_error():
    for name, build in GRAPHS.items():
        assert build(T).topo_order() == build(J).topo_order(), name
    conf = residual_mlp(T)
    order = conf.topo_order()
    assert order.index("d1") < order.index("d2") < order.index("res") \
        < order.index("out")
    conf.nodes["d1"].inputs = ["d2"]
    with pytest.raises(ValueError, match="cycle"):
        conf.topo_order()
    conf = residual_mlp(T)
    conf.nodes["d1"].inputs = ["nowhere"]
    with pytest.raises(ValueError, match="missing input"):
        conf.topo_order()


def test_graph_builder_builds_a_computation_graph():
    conf = residual_mlp(T)
    assert isinstance(conf, TN.ComputationGraphConfiguration)
    assert conf.max_grad_norm == 0.5 and conf.grad_clip_value == 0.2
    g = TN.ComputationGraph(conf, device="cpu").init()
    assert g.num_params() == J.G.ComputationGraph(residual_mlp(J)).init() \
        .num_params()
    assert g.summary().splitlines()[3].split()[:2] == ["d1", "DenseLayer"]


# -- init from a seed --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_init_params_from_a_seed_are_jax_params(name):
    jg = J.G.ComputationGraph(GRAPHS[name](J)).init()
    tg = T.G.ComputationGraph(GRAPHS[name](T), device="cpu").init()
    for k, p in jg.params().items():
        for n, v in p.items():
            a, b = np.asarray(v), _np(tg.params()[k][n])
            ulp = np.spacing(np.abs(a).astype(np.float32))
            assert np.all(np.abs(a - b) <= 3 * ulp), (k, n)
    assert tuple(np.asarray(jg._rng).tolist()) == tuple(tg._rng)


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_three_adam_steps_with_clipping_follow_jax(name):
    jg, tg = _pair(GRAPHS[name])
    x, y = _data(name)
    for _ in range(3):
        jg.fit(x, y)
        tg.fit(x, y)
        assert abs(tg.score_ - float(jg.score_)) <= \
            LOSS_RTOL * abs(float(jg.score_))
    assert tg._step == jg._step == 3
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tg.params())
    want = jg.output(*x) if isinstance(x, list) else jg.output(x)
    got = tg.output(*x) if isinstance(x, list) else tg.output(x)
    for w, g_ in zip(want if isinstance(want, list) else [want],
                     got if isinstance(got, list) else [got]):
        assert np.abs(_np(g_) - np.asarray(w)).max() <= OUT_ATOL


def test_fit_takes_iterators_and_fires_listeners():
    class Listener:
        def __init__(self):
            self.events = []

        def iteration_done(self, model, it, epoch):
            self.events.append(("it", it, epoch))

        def on_timing(self, model, seconds, batch):
            self.events.append(("timing", batch))

        def on_epoch_end(self, model):
            self.events.append(("epoch",))

    jg, tg = _pair(multi_io)
    x, y = _data("multi_io")
    lj, lt = Listener(), Listener()
    jg.set_listeners(lj)
    tg.set_listeners(lt)
    batches = [(x, y), (x, y)]
    jg.fit(batches, epochs=2)
    tg.fit(iter(batches), epochs=2)
    assert lt.events == lj.events
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tg.params())


# -- masks -------------------------------------------------------------------

def masked_rnn(S):
    """Two sequence inputs: "a" through an RNN, merged with "b", a
    stack/unstack pair, masked global pooling and two outputs."""
    return (S.N.NeuralNetConfiguration.builder().seed(11)
            .updater(S.U.Adam(1e-2)).graph_builder()
            .add_inputs("a", "b")
            .set_input_types(S.C.InputType.recurrent(3, 6),
                             S.C.InputType.recurrent(3, 6))
            .add_layer("ra", S.R.SimpleRnn(n_out=4), "a")
            .add_layer("rb", S.R.SimpleRnn(n_out=4), "b")
            .add_vertex("m", S.G.MergeVertex(), "ra", "rb")
            .add_vertex("st", S.G.StackVertex(), "ra", "rb")
            .add_vertex("u1", S.G.UnstackVertex(1, 2), "st")
            .add_layer("pm", S.L.GlobalPoolingLayer(pooling="avg"), "m")
            .add_layer("pu", S.L.GlobalPoolingLayer(pooling="max"), "u1")
            .add_vertex("cat", S.G.MergeVertex(), "pm", "pu")
            .add_layer("out", S.L.OutputLayer(n_out=2), "cat")
            .add_layer("seq", S.R.RnnOutputLayer(n_out=2), "m")
            .set_outputs("out", "seq")
            .build())


@pytest.mark.parametrize("which", ["both", "a_only", "b_only"])
def test_per_input_masks_propagate_as_in_jax(which):
    jg, tg = _pair(masked_rnn)
    rs = np.random.RandomState(3)
    xa, xb = (rs.randn(4, 6, 3).astype(np.float32) for _ in range(2))
    ma = (np.arange(6)[None] < np.array([6, 4, 2, 1])[:, None]).astype(
        np.float32)
    mb = (np.arange(6)[None] < np.array([3, 6, 5, 2])[:, None]).astype(
        np.float32)
    masks = {"both": {"a": ma, "b": mb}, "a_only": {"a": ma},
             "b_only": {"b": mb}}[which]
    want = jg.output({"a": xa, "b": xb}, mask=masks)
    got = tg.output({"a": xa, "b": xb}, mask=masks)
    for w, g_ in zip(want, got):
        assert np.abs(_np(g_) - np.asarray(w)).max() <= OUT_ATOL
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    ys = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (4, 6))]
    batch = [([xa, xb], [y, ys], {**masks, "seq": ma})]
    jg.fit(batch)
    tg.fit(batch)
    assert abs(tg.score_ - float(jg.score_)) <= \
        LOSS_RTOL * abs(float(jg.score_))
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tg.params())


def test_a_bare_mask_on_a_multi_input_graph_is_refused():
    tg = T.G.ComputationGraph(masked_rnn(T), device="cpu").init()
    x = np.zeros((2, 6, 3), np.float32)
    with pytest.raises(ValueError, match="ambiguous"):
        tg.output({"a": x, "b": x}, mask=np.ones((2, 6), np.float32))


# -- truncated BPTT ----------------------------------------------------------

def tbptt_graph(S, tbptt=10, two_inputs=False):
    b = (S.N.NeuralNetConfiguration.builder().seed(3).updater(S.U.Adam(1e-2))
         .graph_builder())
    if two_inputs:
        b = (b.add_inputs("a", "b")
             .set_input_types(S.C.InputType.recurrent(3, 23),
                              S.C.InputType.recurrent(3, 15))
             .add_layer("la", S.R.LSTM(n_out=6), "a")
             .add_layer("pa", S.L.GlobalPoolingLayer("max"), "la")
             .add_layer("lb", S.R.LSTM(n_out=6), "b")
             .add_layer("pb", S.L.GlobalPoolingLayer("max"), "lb")
             .add_vertex("m", S.G.MergeVertex(), "pa", "pb")
             .add_layer("out", S.L.OutputLayer(n_out=2, loss="mcxent"), "m"))
    else:
        b = (b.add_inputs("in")
             .set_input_types(S.C.InputType.recurrent(3, 23))
             .add_layer("rnn", S.R.LSTM(n_out=8), "in")
             .add_layer("out", S.R.RnnOutputLayer(n_out=2, loss="mcxent"),
                        "rnn"))
    conf = b.set_outputs("out").build()
    conf.tbptt_fwd_length = tbptt
    return conf


class HeldStepGraph(TG.ComputationGraph):
    """The rule JAX's graph does NOT follow: every chunk at the batch's
    step number (its MultiLayerNetwork's rule)."""

    def _fit_tbptt(self, inputs, labels, masks, tbptt):
        real, step = self.apply_gradients, self._step

        def held(grads, new_state=None):
            real(grads, new_state)
            self._step = step
        self.apply_gradients = held
        try:
            return super()._fit_tbptt(inputs, labels, masks, tbptt)
        finally:
            del self.apply_gradients
            self._step = step + 1


def _worst_rel(jtree, ttree):
    return max(float(np.abs(np.asarray(v) - _np(ttree[k][n])).max())
               / max(float(np.abs(np.asarray(v)).max()), 1e-30)
               for k, p in jtree.items() for n, v in p.items())


def test_graph_tbptt_counts_one_step_a_chunk_as_jax_does():
    """T=23 in chunks of 10: 3 chunks, 3 steps, JAX's params; the same
    fit with the step held per batch misses JAX's params by far more
    than the tolerance (Adam's bias correction sees another t)."""
    rs = np.random.RandomState(0)
    x = rs.rand(4, 23, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 1.5).astype(int)]
    jg, tg = _pair(tbptt_graph)
    held = HeldStepGraph(tbptt_graph(T), device="cpu").init()
    held.set_params(tg.params())
    for g in (jg, tg, held):
        g.fit([([x], [y])])
        g.fit([([x], [y])])
    assert jg._step == tg._step == 6 and held._step == 2
    jparams = jax.tree.map(np.asarray, jg.params())
    _assert_params_close(jparams, tg.params())
    assert _worst_rel(jparams, held.params()) > 10 * PARAM_TOL
    assert abs(tg.score_ - float(jg.score_)) <= \
        LOSS_RTOL * abs(float(jg.score_))


def test_graph_tbptt_pads_unequal_inputs_as_jax_does():
    rs = np.random.RandomState(1)
    xa = rs.rand(4, 23, 3).astype(np.float32)
    xb = rs.rand(4, 15, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    jg, tg = _pair(lambda S: tbptt_graph(S, tbptt=10, two_inputs=True))
    jg.fit([([xa, xb], [y])], epochs=2)
    tg.fit([([xa, xb], [y])], epochs=2)
    assert tg._step == jg._step == 6
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tg.params())


def test_short_sequences_take_the_plain_step():
    """T no longer than the chunk: the plain step, bit for bit the
    same graph without TBPTT."""
    x = np.random.RandomState(0).rand(2, 23, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.zeros((2, 23), int)]
    graphs = [T.G.ComputationGraph(tbptt_graph(T, tbptt=n),
                                   device="cpu").init() for n in (30, 0)]
    for g in graphs:
        g.fit([([x], [y])])
    assert graphs[0]._step == graphs[1]._step == 1
    assert graphs[0]._rng == graphs[1]._rng
    for k, p in graphs[1].params().items():
        for n, t in p.items():
            assert torch.equal(graphs[0].params()[k][n], t)


# -- the bf16 policy ---------------------------------------------------------

def bf16_cnn(S, has_bias=False):
    """ResNet's conv + batch norm + residual add, at bf16. The convs
    carry no bias there, as in ResNet: XLA reduces a bf16 bias gradient
    over the positions in bf16 (see the next test)."""
    return (S.N.NeuralNetConfiguration.builder().seed(9)
            .updater(S.U.Sgd(0.1)).data_type("bfloat16").graph_builder()
            .add_inputs("img")
            .set_input_types(S.C.InputType.convolutional(8, 8, 2))
            .add_layer("c1", S.L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                                  activation="relu",
                                                  has_bias=has_bias), "img")
            .add_layer("bn", S.L.BatchNormalization(), "c1")
            .add_layer("c2", S.L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                                  activation="identity",
                                                  has_bias=has_bias),
                       "bn")
            .add_vertex("res", S.G.ElementWiseVertex("add"), "bn", "c2")
            .add_layer("gp", S.L.GlobalPoolingLayer("avg"), "res")
            .add_layer("out", S.L.OutputLayer(n_out=3), "gp")
            .set_outputs("out").build())


def test_bf16_policy_follows_jax_compiled_fit():
    jg, tg = _pair(bf16_cnn)
    rs = np.random.RandomState(4)
    x = rs.randn(8, 8, 8, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    before = jax.tree.map(np.asarray, jg.params())
    jg.fit(x, y)
    tg.fit(x, y)
    assert abs(tg.score_ - float(jg.score_)) <= \
        BF16_LOSS_RTOL * abs(float(jg.score_))
    after = jax.tree.map(np.asarray, jg.params())
    for k, p in before.items():
        for n, v in p.items():
            want = after[k][n] - v
            got = _np(tg.params()[k][n]) - v
            assert tg.params()[k][n].dtype == torch.float32
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= BF16_UPDATE_TOL * scale, \
                (k, n)


def test_bf16_conv_bias_gradient_is_the_f32_sum_of_jax_own_upstream():
    """A conv bias under the bf16 policy: the port's gradient is the f32
    sum over the positions of the gradient reaching the conv's output,
    which JAX computes alike (here within one bf16 rounding of it); JAX's
    own bias gradient is that sum reduced in bf16 by XLA, 0.75 where the
    f32 sum is 0.575 for one channel here, so it is not the reference
    for this leaf."""
    from deeplearning4j_tpu.nn.precision import \
        cast_params_for_compute as jcast
    jg, tg = _pair(lambda S: bf16_cnn(S, has_bias=True))
    rs = np.random.RandomState(4)
    x = rs.randn(8, 8, 8, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    p = jg.params()
    acts, _ = jg._forward(jcast(p, {"out"}, jax.numpy.bfloat16),
                          jg._net_state,
                          {"img": jax.numpy.asarray(x, jax.numpy.bfloat16)},
                          True, None)

    def tail(res):
        pooled = jg.conf.nodes["gp"].layer.apply({}, res, {}, True, None)[0]
        return jg.conf.nodes["out"].layer.compute_loss(
            p["out"], pooled.astype(np.float32), jax.numpy.asarray(y), None,
            train=True)
    upstream = np.asarray(jax.grad(tail)(acts["res"]).astype(np.float32))
    want = upstream.sum((0, 1, 2))
    _, grads, _, _ = tg._grads(tg._as_inputs(x), tg._as_labels(y), None,
                               None)
    got = _np(grads["c2"]["b"])
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()


# -- remat -------------------------------------------------------------------

def remat_graph(S, remat):
    return (S.N.NeuralNetConfiguration.builder().seed(13)
            .updater(S.U.Adam(1e-2)).remat(remat).graph_builder()
            .add_inputs("img")
            .set_input_types(S.C.InputType.convolutional(8, 8, 2))
            .add_layer("c1", S.L.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                                  activation="relu",
                                                  dropout=0.3), "img")
            .add_layer("bn", S.L.BatchNormalization(activation="relu"),
                       "c1")
            .add_layer("c2", S.L.ConvolutionLayer(n_out=4, kernel=(3, 3)),
                       "bn")
            .add_vertex("res", S.G.ElementWiseVertex("add"), "bn", "c2")
            .add_layer("gp", S.L.GlobalPoolingLayer("max"), "res")
            .add_layer("out", S.L.OutputLayer(n_out=3, dropout=0.2), "gp")
            .set_outputs("out").build())


def test_remat_is_bit_for_bit():
    rs = np.random.RandomState(5)
    x = rs.randn(6, 8, 8, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    plain = T.G.ComputationGraph(remat_graph(T, False), device="cpu").init()
    remat = T.G.ComputationGraph(remat_graph(T, True), device="cpu").init()
    for _ in range(3):
        plain.fit(x, y)
        remat.fit(x, y)
    for k, p in plain.params().items():
        for n, t in p.items():
            assert torch.equal(t, remat.params()[k][n]), (k, n)
    for k, st in plain.get_net_state().items():
        for n, t in st.items():
            assert torch.equal(t, remat.get_net_state()[k][n])
    # and dropout draws JAX's masks: the remat graph follows JAX's
    jg = J.G.ComputationGraph(remat_graph(J, True)).init()
    tg = T.G.ComputationGraph(remat_graph(T, True), device="cpu").init()
    tg.set_params(graph_params_from_jax(jax.tree.map(np.asarray,
                                                     jg.params())))
    for _ in range(2):
        jg.fit(x, y)
        tg.fit(x, y)
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tg.params())


# -- the archive -------------------------------------------------------------

def test_archives_cross_restore_and_resume_bit_for_bit(tmp_path):
    x, y = _data("cnn")
    jg, tg = _pair(cnn_graph)
    for _ in range(2):
        jg.fit(x, y)
        tg.fit(x, y)
    pj, pt = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JSer.write_model(jg, pj)
    ModelSerializer.write_model(tg, pt)
    with zipfile.ZipFile(pt) as z:
        meta = json.loads(z.read("meta.json"))
        with zipfile.ZipFile(pj) as zj:
            assert sorted(z.namelist()) == sorted(zj.namelist())
    assert meta["model_type"] == "ComputationGraph" and meta["step"] == 2
    # JAX restores the port's archive, the port JAX's
    jr = JSer.restore(pt)
    assert type(jr).__name__ == "ComputationGraph"
    _assert_params_close(jax.tree.map(np.asarray, jr.params()), tg.params(),
                         tol=0.0)
    tr = ModelSerializer.restore_computation_graph(pj, device="cpu")
    assert isinstance(tr, TN.ComputationGraph) and tr._step == 2
    _assert_params_close(jax.tree.map(np.asarray, jg.params()), tr.params(),
                         tol=0.0)
    # a port archive resumes bit for bit in the port
    resumed = ModelSerializer.restore(pt, device="cpu")
    assert resumed._rng == tg._rng and resumed._step == tg._step
    for g in (tg, resumed):
        g.fit(x, y)
    for k, p in tg.params().items():
        for n, t in p.items():
            assert torch.equal(t, resumed.params()[k][n])
    for k, st in tg.get_updater_state().items():
        for part, leaves in st.items():
            for n, t in leaves.items():
                assert torch.equal(t, resumed.get_updater_state()[k][part][n])


def test_resnet50_adam_archive_resumes_bit_for_bit(tmp_path):
    """The zoo's ResNet-50 (its Adam archive is ~300 MB at full width)
    at a small input: written after a step, restored, and the next step
    of both bit for bit. On one intra-op thread: the suite's six
    workers share the CPU, and PyTorch's thread pool, oversubscribed
    there, ran this test 18x slower than alone."""
    from deeplearning4j_tpu_torch.zoo import ResNet50
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _resnet50_round_trip(tmp_path, ResNet50)
    finally:
        torch.set_num_threads(threads)


def _resnet50_round_trip(tmp_path, ResNet50):
    g = ResNet50(num_classes=5, input_shape=(32, 32, 3), device="cpu").init()
    rs = np.random.RandomState(8)
    x = rs.randn(4, 32, 32, 3).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 4]]
    g.fit(x, y)
    path = str(tmp_path / "resnet50.zip")
    ModelSerializer.write_model(g, path)
    back = ModelSerializer.restore(path, device="cpu")
    assert back._step == 1 and back._rng == g._rng
    g.fit(x, y)
    back.fit(x, y)
    for tree, other in ((g.params(), back.params()),
                        (g.get_net_state(), back.get_net_state())):
        for k, p in tree.items():
            for n, t in p.items():
                assert torch.equal(t, other[k][n]), (k, n)
    for k, st in g.get_updater_state().items():
        for part, leaves in st.items():
            for n, t in leaves.items():
                assert torch.equal(t, back.get_updater_state()[k][part][n])


def test_sharded_archive_restores_a_graph(tmp_path):
    tg = T.G.ComputationGraph(multi_io(T), device="cpu").init()
    x, y = _data("multi_io")
    tg.fit(x, y)
    snap = TS.snapshot_training_state(tg)
    shards, manifest = TS.shard_training_snapshot(snap, 2)
    d = tmp_path / "ckpt"
    d.mkdir()
    for i, sh in enumerate(shards):
        TS.write_shard(sh, str(d / TS.shard_name(i)))
    with open(d / TS.MANIFEST_NAME, "w") as f:
        json.dump(manifest, f)
    g2 = ModelSerializer.restore(str(d), device="cpu")
    assert isinstance(g2, TN.ComputationGraph) and g2._step == 1
    for k, p in tg.params().items():
        for n, t in p.items():
            assert torch.equal(t, g2.params()[k][n])


# -- serving -----------------------------------------------------------------

def test_inference_engine_serves_a_graph_by_name():
    jg, tg = _pair(multi_io)
    eng = InferenceEngine(tg, max_batch_size=8)
    assert eng._kind == "graph"
    x, _ = _data("multi_io", n=3)
    feed = {"a": x[0], "b": x[1]}
    res = eng.predict(feed)
    want = tg.output(*x)
    assert isinstance(res, list) and len(res) == 2
    for r, w in zip(res, want):
        assert np.array_equal(r, _np(w))
    named = eng.predict(feed, outputs=["out2"])
    assert set(named) == {"out2"}
    assert np.array_equal(named["out2"], _np(want[1]))
    for bad, match in ((dict(feed, c=x[0]), "unknown input"),
                       ({"a": x[0]}, "needs inputs"),
                       (x[0], "multi-input")):
        with pytest.raises(ClientError, match=match):
            eng.predict(bad)
    with pytest.raises(ClientError, match="unknown outputs"):
        eng.predict(feed, outputs=["nope"])
    with pytest.raises(ClientError, match="inconsistent batch"):
        eng.predict({"a": x[0], "b": x[1][:2]})
    # the JAX engine answers the same rows
    from deeplearning4j_tpu.serving.engine import \
        InferenceEngine as JInferenceEngine
    jres = JInferenceEngine(jg, max_batch_size=8).predict(feed)
    for r, w in zip(res, jres):
        assert np.abs(r - np.asarray(w)).max() <= OUT_ATOL


def test_served_rows_follow_set_params_and_batch_norm_runs_on_stats():
    tg = T.G.ComputationGraph(bf16_cnn(T), device="cpu").init()
    eng = InferenceEngine(tg, max_batch_size=8)
    eng.warmup([1, 4])
    rs = np.random.RandomState(6)
    x = rs.randn(3, 8, 8, 2).astype(np.float32)
    assert np.array_equal(eng.predict(x), _np(tg.output(x)))
    leaves = eng._leaves()
    new = {k: {n: t.detach() * 0.5 for n, t in p.items()}
           for k, p in tg.params().items()}
    tg.set_params(new)
    tg.set_net_state({k: {n: t + 0.25 for n, t in st.items()}
                      for k, st in tg.get_net_state().items()})
    assert not eng._same_leaves(leaves)   # every leaf replaced
    rows = eng.predict(x)
    assert np.array_equal(rows, _np(tg.output(x)))
    assert not np.allclose(rows, _np(tg.output(x, train=True)))
    assert eng.metrics.compiles == 2


def test_captured_rows_follow_set_params_and_set_net_state(monkeypatch):
    """The card's entry, a capture replayed over the leaves it saw (run
    here by the stand-in of ``_torch_serving_util.recording_graphs``):
    after ``set_params`` and ``set_net_state`` the bucket served captures
    once more over the new leaves, uncounted in ``compiles``, and serves
    the new ``output()``; a replay over the old leaves would serve the
    old rows."""
    from _torch_serving_util import recording_graphs
    captures = recording_graphs(monkeypatch)
    tg = T.G.ComputationGraph(bf16_cnn(T), device="cpu").init()
    eng = InferenceEngine(tg, max_batch_size=8)
    eng.warmup([1, 4])
    assert len(captures) == eng.captures == 2
    x = np.random.RandomState(7).randn(3, 8, 8, 2).astype(np.float32)
    old = eng.predict(x)
    assert np.array_equal(old, _np(tg.output(x)))
    tg.set_params({k: {n: t.detach() * 0.5 for n, t in p.items()}
                   for k, p in tg.params().items()})
    tg.set_net_state({k: {n: t + 0.25 for n, t in st.items()}
                      for k, st in tg.get_net_state().items()})
    rows = eng.predict(x)
    assert np.array_equal(rows, _np(tg.output(x)))
    assert np.abs(rows - old).max() > 1e-3
    assert len(captures) == eng.captures == 3
    assert np.array_equal(eng.predict(x), rows) and len(captures) == 3
    # the layer state alone is served too
    tg.set_net_state({k: {n: t + 0.5 for n, t in st.items()}
                      for k, st in tg.get_net_state().items()})
    again = eng.predict(x)
    assert np.array_equal(again, _np(tg.output(x)))
    assert np.abs(again - rows).max() > 1e-3
    assert len(captures) == 4 and eng.metrics.compiles == 2


def test_inference_engine_takes_a_single_input_graph_bare():
    tg = T.G.ComputationGraph(cnn_graph(T), device="cpu").init()
    eng = InferenceEngine(tg)
    assert eng.warmup([2]) == [2]
    x, _ = _data("cnn", n=2)
    assert np.array_equal(eng.predict(x), _np(tg.output(x)))
    assert np.array_equal(eng.predict({"img": x}), eng.predict(x))


# -- the rest of the surface -------------------------------------------------

def test_feed_forward_score_evaluate_clone():
    jg, tg = _pair(residual_mlp)
    x, y = _data("residual")
    ja, ta = jg.feed_forward(x), tg.feed_forward(x)
    assert set(ta) == set(ja)
    for k in ja:
        assert np.abs(_np(ta[k]) - np.asarray(ja[k])).max() <= OUT_ATOL
    assert abs(tg.score(x, y) - jg.score(x, y)) <= LOSS_RTOL * abs(
        jg.score(x, y))
    assert np.array_equal(tg.evaluate([(x, y)])._conf,
                          jg.evaluate([(x, y)])._conf)
    c = tg.clone()
    assert np.array_equal(_np(c.output(x)), _np(tg.output(x)))
    assert c._step == 0 and c.get_updater_state() is not None
    assert tg.summary().splitlines()[-2] == jg.summary().splitlines()[-2]


def test_pretraining_is_refused():
    """Pretraining is ported (tests/test_torch_pretrain_layers.py); a
    node that is not pretrainable is refused as JAX refuses it, and a
    graph without one pretrains nothing."""
    tg = T.G.ComputationGraph(residual_mlp(T), device="cpu").init()
    jg = J.G.ComputationGraph(residual_mlp(J)).init()
    before = {k: {n: t.detach().clone() for n, t in p.items()}
              for k, p in tg.params().items()}
    assert tg.pretrain([]) is tg
    for g in (tg, jg):
        with pytest.raises(ValueError, match="not pretrainable"):
            g.pretrain_node("d1", [])
    assert all(torch.equal(t, before[k][n]) for k, p in tg.params().items()
               for n, t in p.items())
