"""The port's MultiLayerNetwork against the JAX package's (f32, CPU).

A causal transformer LM in the layer DSL (EmbeddingSequence -> 2 x
TransformerEncoder -> RnnOutputLayer, d_model 32, T=32, vocab 64) is
built in both packages; the JAX network's params are carried across,
and the same numpy-seeded batch goes through both. With
``implementation="flash"`` the JAX side runs its Pallas kernels in
interpret mode and the port its flash autograd Function (the plain
versions of the forward and backward kernels, on the CPU).

Tolerances, with their reasons:
- loss and every gradient leaf: rtol 1e-4, atol 1e-5 (f32 on both
  sides, summed in another order);
- five Adam steps at lr 1e-3: losses and params within atol 1e-4.
  Adam's first steps move a param by ~lr * sign(g); where |g| is
  near zero, eps (1e-8) keeps the step far below 1e-4, so rounding
  cannot flip a step by 2e-3. Measured: params within 5.2e-6;
- Adam's m and v after those steps: rtol 1e-3, atol 1e-7 (they
  accumulate gradients whose smallest entries carry the summation-order
  error relative to their size).

At ``data_type("bfloat16")`` (the bf16 mixed-precision policy on both
sides: every layer but the output layer computes in bf16, masters and
Adam state stay f32), with the same params and batch:
- loss: rtol 1e-2 (bf16 activations round at ~2^-9 per op; measured
  2.8e-4);
- every gradient leaf within 4e-2 of its largest magnitude. The two
  sides round bf16 at different places (JAX's GELU rounds each of its
  seven bf16 ops, PyTorch's once from f32; the backward's reductions
  run in another order), and the small leaves (layer-norm gains,
  biases) sum 128 tokens' bf16 terms. JAX's own bf16 gradients stand up
  to 3.7e-2 from its f32 gradients on those leaves, the port's 2.0e-2
  (measured, CPU), so the two differ by up to 3.4e-2 (measured over
  four batches); 2e-2 would hold the port to JAX's own rounding;
- three Adam steps at lr 1e-3: params within 2 * lr per step (Adam's
  first steps move a param by ~lr * sign(g), and a bf16-rounded
  gradient near 0 may flip one step's sign; measured 4.1e-3 of the
  6e-3 after three steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers.attention import \
    TransformerEncoderLayer as JEncoder
from deeplearning4j_tpu.nn.layers.recurrent import \
    EmbeddingSequenceLayer as JEmb
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu_torch.convert import (network_params_from_jax,
                                              updater_state_from_jax)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerConfiguration,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, GlobalPoolingLayer,
                                                OutputLayer)
from deeplearning4j_tpu_torch.nn.layers.attention import \
    TransformerEncoderLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    EmbeddingSequenceLayer, RnnOutputLayer)
from _torch_threads import one_torch_thread  # noqa: F401,E402

RTOL, ATOL = 1e-4, 1e-5
STEP_ATOL = 1e-4
V, D, T, B = 64, 32, 32, 4

JAX_SIDE = (JConf, JEmb, JEncoder, JRnnOut, JAdam)
PORT_SIDE = (NeuralNetConfiguration, EmbeddingSequenceLayer,
             TransformerEncoderLayer, RnnOutputLayer, Adam)


def _lm_conf(side, impl, l2=0.0, max_norm=None, lr=1e-3, dropout=None,
             dtype=None):
    Conf, Emb, Enc, Out, Opt = side
    b = Conf.builder().seed(0).updater(Opt(lr)).weight_init("xavier")
    if dtype:
        b = b.data_type(dtype)
    if l2:
        b = b.l2(l2)
    if max_norm:
        b = b.gradient_normalization(max_norm=max_norm)
    enc = dict(n_heads=4, d_ff=64, causal=True, implementation=impl)
    if dropout:
        enc["dropout"] = dropout
    return (b.list().layer(Emb(n_in=V, n_out=D))
            .layer(Enc(**enc)).layer(Enc(**enc))
            .layer(Out(n_out=V, loss="mcxent", activation="softmax"))
            .input_type_recurrent(1, timesteps=T).build())


BF16_LOSS_RTOL = 1e-2
BF16_GRAD_TOL = 4e-2
BF16_LR = 1e-3


def _pair(impl, **kw):
    jn = JNet(_lm_conf(JAX_SIDE, impl, **kw)).init()
    tn = MultiLayerNetwork(_lm_conf(PORT_SIDE, impl, **kw),
                           device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    return jn, tn


def _batch(seed=0, masked=False):
    """Tokens of a learnable recurrence (next = 5 * t + 3 mod V) and
    one-hot labels; the mask pads row 1 to 20 tokens and masks row 2
    entirely."""
    rs = np.random.RandomState(seed)
    x = rs.randint(0, V, (B, T))
    y = np.eye(V, dtype=np.float32)[(5 * x + 3) % V]
    if not masked:
        return x, y, None
    m = np.ones((B, T), np.float32)
    m[1, 20:] = 0.0
    m[2] = 0.0
    return x, y, m


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _jax_loss_and_grads(jn, x, y, m):
    def loss(p):
        return jn._loss_fn(p, jn._net_state, jnp.asarray(x), jnp.asarray(y),
                           None if m is None else jnp.asarray(m), True,
                           None)[0]
    return jax.value_and_grad(loss)(jn.params())


def test_init_from_the_seed_is_jax_init():
    """``init`` draws layer i's params from key i + 1 of
    ``split(PRNGKey(seed), n_layers + 1)``, as JAX does: JAX's params
    (``normal`` within 8 f32 ulp of each weight, the rest exact)."""
    jn = JNet(_lm_conf(JAX_SIDE, "plain")).init()
    tn = MultiLayerNetwork(_lm_conf(PORT_SIDE, "plain"), device="cpu").init()
    jp = jax.tree.map(np.asarray, jn.params())
    assert jp.keys() == tn.params().keys()
    for k, p in jp.items():
        assert p.keys() == tn.params()[k].keys()
        for n, v in p.items():
            got = tn.params()[k][n].detach().numpy()
            assert np.all(np.abs(got - v) <= 8 * np.spacing(np.abs(v))), \
                (k, n)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_loss_and_every_gradient_match_jax(impl, masked):
    jn, tn = _pair(impl)
    x, y, m = _batch(masked=masked)
    jl, jg = _jax_loss_and_grads(jn, x, y, m)
    tl, tg = tn.loss_and_gradients(x, y, m)
    _close(float(tl), float(jl))
    assert sorted(tg) == sorted(jg)
    for key in jg:
        assert sorted(tg[key]) == sorted(jg[key])
        for name in jg[key]:
            _close(tg[key][name].numpy(), jg[key][name], what=f"{key}.{name}")
    for key in ("layer_1", "layer_2"):
        # the attention projections get their gradient through the
        # flash Function's backward, not a detached kernel output
        for name in ("attn_Wq", "attn_Wk", "attn_Wv"):
            assert tg[key][name].abs().max().item() > 0.0


def _run_steps(jn, tn, x, y, m, steps=5):
    jl, tl = [], []
    for _ in range(steps):
        jn.fit(x, y, mask=m)
        tn.fit(x, y, mask=m)
        jl.append(float(jn._last_loss))
        tl.append(tn.score_)
    _close(tl, jl, rtol=0, atol=STEP_ATOL, what="loss trajectory")
    assert tl[-1] < tl[0]
    jp = jn.params()
    for key, p in tn.params().items():
        for name, t in p.items():
            _close(t.detach().numpy(), jp[key][name], rtol=0,
                   atol=STEP_ATOL, what=f"{key}.{name}")


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_five_adam_steps_match_jax(impl):
    jn, tn = _pair(impl)
    x, y, _ = _batch(1)
    _run_steps(jn, tn, x, y, None)
    ju = updater_state_from_jax(jax.tree.map(np.asarray,
                                             jn.get_updater_state()))
    for key, st in tn.get_updater_state().items():
        for part in ("m", "v"):
            for name, t in st[part].items():
                _close(t.numpy(), ju[key][part][name], rtol=1e-3, atol=1e-7,
                       what=f"{key}.{part}.{name}")


def test_key_mask_with_a_fully_masked_row_matches_jax():
    jn, tn = _pair("flash")
    _run_steps(jn, tn, *_batch(2, masked=True))


def test_l2_and_gradient_normalization_match_jax():
    jn, tn = _pair("flash", l2=1e-2, max_norm=0.5)
    _run_steps(jn, tn, *_batch(3))


def test_output_and_score_match_jax():
    jn, tn = _pair("flash")
    x, y, m = _batch(4, masked=True)
    _close(tn.output(x, mask=m).numpy(), jn.output(x, mask=m))
    _close(tn.score(x, y, m), jn.score(x, y, m))
    assert tn.num_params() == jn.num_params()


def test_adam_state_carries_across():
    """A port network resumed from a JAX network's params and Adam
    state continues its trajectory."""
    jn, tn = _pair("plain")
    x, y, _ = _batch(5)
    for _ in range(2):
        jn.fit(x, y)
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    tn.set_updater_state(updater_state_from_jax(
        jax.tree.map(np.asarray, jn.get_updater_state())))
    tn._step = jn._step
    jn.fit(x, y)
    tn.fit(x, y)
    for key, p in tn.params().items():
        for name, t in p.items():
            _close(t.detach().numpy(), jn.params()[key][name], rtol=0,
                   atol=STEP_ATOL, what=f"{key}.{name}")


def test_fit_takes_iterators_and_tensors():
    _, a = _pair("plain")
    _, b = _pair("plain")
    _, c = _pair("plain")
    x, y, _ = _batch(6)
    a.fit(x, y, epochs=2)
    b.fit(ArrayDataSetIterator(x, y, batch=B), epochs=2)
    c.fit([(torch.from_numpy(x), torch.from_numpy(y))], epochs=2)
    for net in (b, c):
        assert net._step == a._step == 2
        for key, p in a.params().items():
            for name, t in p.items():
                assert torch.equal(net.params()[key][name], t)


# -- the JAX package's learnable task (tests/test_attention_elastic.py) --
def _seq_task(np_rng, n=128, T=12, C=8):
    X = np_rng.randn(n, T, C).astype(np.float32)
    y = (X[:, :T // 2].mean((1, 2)) > X[:, T // 2:].mean((1, 2))).astype(int)
    return X, np.eye(2, dtype=np.float32)[y]


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_transformer_stack_learns(np_rng, impl):
    """The JAX test's own bar: accuracy above 0.85 after 60 epochs."""
    X, Y = _seq_task(np_rng)
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(3e-3))
            .weight_init("xavier").list()
            .layer(TransformerEncoderLayer(n_heads=2, d_ff=32,
                                           implementation=impl))
            .layer(GlobalPoolingLayer(pooling="avg"))
            .layer(OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
            .input_type_recurrent(8, timesteps=12).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(ArrayDataSetIterator(X, Y, batch=32), epochs=60)
    pred = net.output(X).argmax(-1).numpy()
    assert (pred == Y.argmax(-1)).mean() > 0.85


def test_unported_options_raise():
    # dropout is ported (tests/test_torch_dropout.py): a block with
    # dropout trains
    MultiLayerNetwork(_lm_conf(PORT_SIDE, "plain", dropout=0.1),
                      device="cpu").fit(*_batch()[:2])
    # a bf16 configuration builds and trains on the CPU (the bf16
    # policy)
    bf16 = (NeuralNetConfiguration.builder().seed(0).data_type("bfloat16")
            .updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=2)).input_type_feed_forward(3).build())
    net = MultiLayerNetwork(bf16, device="cpu").init()
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 3).astype(np.float32)
    ys = np.eye(2, dtype=np.float32)[(xs.sum(1) > 0).astype(int)]
    first = net.score(xs, ys)
    net.fit(xs, ys, epochs=20)
    assert net.score(xs, ys) < first
    assert all(t.dtype == torch.float32 for p in net.params().values()
               for t in p.values())
    # pure-bf16 params are ported (tests/test_torch_bf16_params.py):
    # init(dtype=bf16) builds bf16 params; an integer dtype is refused
    net.init(dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for p in net.params().values()
               for t in p.values())
    with pytest.raises(ValueError, match="floating"):
        net.init(dtype=torch.int32)
    # TBPTT and remat are ported (tests/test_torch_remat_tbptt.py): a
    # configuration with either builds and trains
    for kw in (dict(tbptt_fwd_length=8), dict(remat=True)):
        c = MultiLayerConfiguration([OutputLayer(n_out=2)],
                                    input_type=InputType.feed_forward(3),
                                    **kw)
        MultiLayerNetwork(c, device="cpu").fit(xs, ys)
    # pretraining is ported (tests/test_torch_pretrain_layers.py): a
    # layer that is not pretrainable is refused as JAX refuses it;
    # rnn_time_step is ported and streams the LM's blocks (which carry
    # no state) token by token
    net = MultiLayerNetwork(_lm_conf(PORT_SIDE, "plain"), device="cpu")
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrain_layer(0, [])
    assert net.pretrain([]) is net
    x = _batch()[0]
    assert tuple(net.rnn_time_step(x).shape) == tuple(net.output(x).shape)
    # weight noise is ported: a DropConnect layer trains
    noisy = DenseLayer(n_out=2, weight_noise={"@class": "dropconnect"})
    assert noisy.weight_noise.keep_prob == 0.5


def test_network_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        net = MultiLayerNetwork(_lm_conf(PORT_SIDE, "auto"))
        assert net.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(_lm_conf(PORT_SIDE, "auto"))


def test_auto_takes_plain_attention_on_cpu(monkeypatch):
    """On the CPU "auto" is plain attention, as in JAX; "flash" is the
    Function with the kernels' plain versions."""
    import deeplearning4j_tpu_torch.nn.layers.attention as att
    calls = []
    real = att.flash_attention_autograd
    monkeypatch.setattr(att, "flash_attention_autograd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x, y, _ = _batch(7)
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    for impl, want in (("auto", 0), ("flash", 2)):
        calls.clear()
        MultiLayerNetwork(_lm_conf(PORT_SIDE, impl), device="cpu").fit(x, y)
        assert len(calls) == want
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == n


# -- the bf16 mixed-precision policy (data_type("bfloat16")) ------------
def _bf16_pair(impl):
    return _pair(impl, dtype="bfloat16")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_bf16_loss_and_every_gradient_match_jax(impl, masked):
    """The bf16 policy's loss and gradients against JAX's: gradients
    reach the f32 masters as f32."""
    jn, tn = _bf16_pair(impl)
    x, y, m = _batch(masked=masked)
    jl, jg = _jax_loss_and_grads(jn, x, y, m)
    tl, tg = tn.loss_and_gradients(x, y, m)
    _close(float(tl), float(jl), rtol=BF16_LOSS_RTOL, atol=0)
    assert sorted(tg) == sorted(jg)
    for key in jg:
        for name, want in jg[key].items():
            got = tg[key][name]
            assert got.dtype == torch.float32
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= BF16_GRAD_TOL * np.abs(want).max(), \
                f"{key}.{name}: {err} of max {np.abs(want).max()}"


def test_bf16_forward_computes_in_bf16(monkeypatch):
    """Every layer but the output layer sees bf16 params and
    activations; the output layer's features come back f32."""
    _, tn = _bf16_pair("flash")
    seen = []
    real = TransformerEncoderLayer.apply_seq

    def spy(self, params, x, *a, **kw):
        seen.append((x.dtype, params["W1"].dtype))
        return real(self, params, x, *a, **kw)
    monkeypatch.setattr(TransformerEncoderLayer, "apply_seq", spy)
    tn.loss_and_gradients(*_batch()[:2])
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
    # output() runs uncast, as in JAX
    assert tn.output(_batch()[0]).dtype == torch.float32


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_bf16_three_adam_steps_match_jax(impl):
    jn, tn = _bf16_pair(impl)
    x, y, _ = _batch(1)
    steps = 3
    losses = []
    for _ in range(steps):
        jn.fit(x, y)
        tn.fit(x, y)
        losses.append(tn.score_)
    _close(tn.score_, float(jn._last_loss), rtol=BF16_LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]
    jp = jn.params()
    for key, p in tn.params().items():
        for name, t in p.items():
            assert t.dtype == torch.float32
            _close(t.detach().numpy(), jp[key][name], rtol=0,
                   atol=2 * BF16_LR * steps, what=f"{key}.{name}")
    for st in tn.get_updater_state().values():
        for part in ("m", "v"):
            assert all(t.dtype == torch.float32 for t in st[part].values())
