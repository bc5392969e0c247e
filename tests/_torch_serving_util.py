"""Helpers shared by the ``test_torch_serving_*`` files: the JAX serving
tests' models built on both sides with the JAX weights carried into the
port, a duck model whose device call the test holds and releases (no
sleep decides an assertion), HTTP helpers, and a stand-in for the CUDA
graph capture so the graph entry's logic runs on the CPU."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np

from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.serving import engine as port_engine


def mlp_conf(side, seed=0, n_in=4, n_out=3):
    """The MLP of ``tests/test_serving_runtime.py:21`` in either
    package (``side`` is "jax" or "port")."""
    if side == "jax":
        from deeplearning4j_tpu.learning import Adam
        from deeplearning4j_tpu.nn import NeuralNetConfiguration
        from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    else:
        from deeplearning4j_tpu_torch.learning import Adam
        from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    return (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=n_out, loss="mcxent",
                               activation="softmax"))
            .input_type_feed_forward(n_in).build())


def classifier_conf(side, T=16, V=64, D=64, layers=2, heads=2, classes=5,
                    seed=0):
    """A d64 x L2 transformer classifier at T=16: embedding, non-causal
    encoder layers, average pooling, a softmax head (the shape of
    ``chip_smoke.py``'s phase 16b)."""
    if side == "jax":
        from deeplearning4j_tpu.learning import Adam
        from deeplearning4j_tpu.nn import NeuralNetConfiguration
        from deeplearning4j_tpu.nn.layers import (GlobalPoolingLayer,
                                                  OutputLayer)
        from deeplearning4j_tpu.nn.layers.attention import \
            TransformerEncoderLayer
        from deeplearning4j_tpu.nn.layers.recurrent import \
            EmbeddingSequenceLayer
    else:
        from deeplearning4j_tpu_torch.learning import Adam
        from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.layers import (GlobalPoolingLayer,
                                                        OutputLayer)
        from deeplearning4j_tpu_torch.nn.layers.attention import \
            TransformerEncoderLayer
        from deeplearning4j_tpu_torch.nn.layers.recurrent import \
            EmbeddingSequenceLayer
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
         .weight_init("xavier").list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(layers):
        b = b.layer(TransformerEncoderLayer(n_heads=heads, d_ff=4 * D,
                                            causal=False,
                                            implementation="plain"))
    return (b.layer(GlobalPoolingLayer("avg"))
            .layer(OutputLayer(n_out=classes, loss="mcxent",
                               activation="softmax"))
            .input_type_recurrent(1, timesteps=T).build())


def net_pair(conf_fn, **kw):
    """The JAX network and the port's (on the CPU) with the JAX weights
    carried across."""
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    jn = JNet(conf_fn("jax", **kw)).init()
    tn = MultiLayerNetwork(conf_fn("port", **kw), device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    return jn, tn


def port_mlp(seed=0, n_in=4, n_out=3):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    return MultiLayerNetwork(mlp_conf("port", seed, n_in, n_out),
                             device="cpu").init()


def lm_pair(**cfg):
    """The JAX CausalTransformerLM (plain attention) and the port's with
    its weights."""
    from deeplearning4j_tpu.zoo.transformer_lm import \
        CausalTransformerLM as JaxLM
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    jlm = JaxLM(**cfg, implementation="plain").init()
    lm = CausalTransformerLM(**cfg, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))
    return jlm, lm


class Gate:
    """Duck-typed model whose ``output()`` blocks until the test sets
    ``release``: a stalled device call under the test's control.
    :meth:`wait_entered` returns once per call that reached the device;
    ``calls`` counts them."""

    def __init__(self, out_cols=1):
        self.release = threading.Event()
        self._entered = threading.Semaphore(0)
        self.calls = 0
        self.out_cols = out_cols

    def output(self, x):
        self.calls += 1
        self._entered.release()
        if not self.release.wait(60.0):
            raise RuntimeError("the test never released the gate")
        return np.zeros((np.asarray(x).shape[0], self.out_cols), np.float32)

    def wait_entered(self, timeout=30.0):
        """Block until one more call is inside ``output()``."""
        assert self._entered.acquire(timeout=timeout), "no device call"


def hold_call(gate, seconds):
    """Release ``gate``'s current call once it has been inside for
    ``seconds`` (so the device call measures at least that)."""
    gate.wait_entered()
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        time.sleep(0.005)
    gate.release.set()


def wait_for(cond, what, timeout=30.0):
    """Poll a condition another thread makes true (a state change, never
    an elapsed time)."""
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.002)


def post(base, path, payload, timeout=60, headers=None):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(base + path, data=json.dumps(payload)
                                 .encode(), headers=hdrs)
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def code_of(base, path, data, headers=None):
    """The status and Retry-After presence of one request (a POST of
    ``data``, a GET when it is None)."""
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
            return r.status, r.headers.get("Retry-After") is not None
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, e.headers.get("Retry-After") is not None


def get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def key_tree(obj, drop=frozenset()):
    """The nested key structure of a JSON document: dicts become
    {key: subtree} (keys in ``drop`` left out at every level), anything
    else its type name."""
    if isinstance(obj, dict):
        return {k: key_tree(v, drop) for k, v in obj.items()
                if k not in drop}
    if isinstance(obj, list):
        return "list"
    if isinstance(obj, bool) or obj is None:
        return type(obj).__name__
    if isinstance(obj, (int, float)):
        return "number"
    return type(obj).__name__


class _ReplayGraph:
    """What :func:`recording_graphs` returns for a capture: its replay
    runs the captured function again, over the params the capture saw
    (a CUDA graph reads the addresses it captured, so a replaced leaf is
    not seen), into the captured output."""

    def __init__(self, run, out):
        self._run, self.out = run, out

    def replay(self):
        time.sleep(0)   # lets other threads run, as a device wait would
        new = self._run()
        if isinstance(self.out, list):   # a graph's named outputs
            for o, n in zip(self.out, new):
                o.copy_(n)
        else:
            self.out.copy_(new)


def recording_graphs(monkeypatch, launches=None):
    """Route the port engine's model entries through ``_Graph`` on the
    CPU, with the capture replaced by :class:`_ReplayGraph`. Each replay
    adds ``launches`` (as a capture would have counted them). Returns the
    list of captures made (one item a capture)."""
    captures = []

    def record(run, engine, device):
        run()                       # the eager warm call
        out = run()
        captures.append([o.shape for o in out] if isinstance(out, list)
                        else out.shape)
        return _ReplayGraph(run, out), out, dict(launches or {})
    monkeypatch.setattr(port_engine, "_record", record)
    monkeypatch.setattr(port_engine, "_Eager", port_engine._Graph)
    return captures
