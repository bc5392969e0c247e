"""ComputationGraph: networks over any DAG of layers and vertices, with
several inputs and outputs (counterpart of
``deeplearning4j_tpu/nn/graph/__init__.py``).

The configuration (``GraphBuilder``, ``ComputationGraphConfiguration``)
is JAX's, and so is its JSON, key for key. The DAG is resolved once to
a topological order in which ready nodes are taken in sorted name
order, so both packages visit the nodes, and hand out their keys, in
the same order. The forward evaluates that order over a dict of
activations; a layer is the same object a ``MultiLayerNetwork`` runs,
a vertex is a small pure function of its inputs' activations.

The step runs eagerly, as ``MultiLayerNetwork``'s does: the loss (the
sum of every output layer's loss on the activation of its input node,
plus the L1/L2 terms) is differentiated by autograd, gradients are
clipped per node, each node's updater turns them into updates that are
subtracted in place under ``torch.no_grad`` (``_subtract``: a half leaf
beside an f32 update is promoted as JAX's ``p - u`` is), constraints
project the params, and the layers' new state is copied into the live
tensors. Params, gradients, updater state and layer state live on the
graph's device: the GPU unless ``device="cpu"`` is asked for.

Randomness is JAX's key chain (``random.py``'s threefry): ``init``
splits ``PRNGKey(seed)`` ``len(order) + 1`` ways (key 0 kept, node
``i`` of the order initialised from key ``i + 1``, so a graph built
from a seed holds JAX's params: uniform draws bit for bit, normal ones
within a few f32 ulp), ``rng, sub = split(rng)`` every step (every
chunk under TBPTT), ``r_fwd, r_out = split(sub)`` in the loss, and node
``i`` draws from row ``i`` of ``split(r_fwd, len(order))``. A row of a
split is one hash of its index, so only the nodes that draw (dropout,
weight noise) compute theirs.

Feature masks are keyed by input name and follow each branch as JAX's
do: a node takes the OR of its masked inputs, an unmasked sequence
input clears it, a stack vertex concatenates masks on the batch (ones
for an unmasked input) and an unstack vertex slices its part, a
``derives_mask`` layer multiplies in its own, and the mask ends once
the activation has no time axis. Recurrent nodes thread carries
(``apply_seq``); truncated BPTT (``conf.tbptt_fwd_length``) pads every
sequence input and sequence label to the longest T with zero masks,
trains it in chunks with the carries detached at each edge, and counts
one step a chunk (JAX's graph does; its ``MultiLayerNetwork`` gives
every chunk the batch's step). With ``conf.remat`` each layer with
params (and every recurrent layer) runs under ``torch.utils.checkpoint``
in training. A half dtype (``data_type("bfloat16")``) trains under the
bf16 policy of ``precision.py``: every node but the outputs computes in
bf16, the output layers, the loss and the masters stay f32.

``pretrain`` and ``pretrain_node`` train each pretrainable node (an
AutoEncoder or VAE) on its own loss over its input node's
inference-mode activation, as JAX's graph does.

Not ported yet, and refused: ``SameDiffLambdaVertex``'s forward
(``autodiff/samediff``, ROADMAP.md queue A, item 15; its JSON still
round-trips).
"""
from __future__ import annotations

import importlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ... import learning as U
from ... import random as R
from ...device import resolve_device
from ..conf import InputType, MultiLayerConfiguration
from ..conf.constraint import apply_constraints
from ..layers import Layer, from_json as layer_from_json
from ..multilayer import (_clip_grads, _detach, _not_ported, _param_dtype,
                          _regularization_penalty, _subtract, pretrain_steps)
from ..precision import (cast_feats_to_f32, cast_input_for_compute,
                         cast_params_for_compute, compute_dtype)

Params = Dict[str, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Vertices: parameterless nodes, pure functions of their inputs
# ---------------------------------------------------------------------------

class GraphVertex:
    """A parameterless DAG node: ``apply(inputs)`` and
    ``output_shape(input_shapes)`` (shapes without the batch axis)."""

    kind = "vertex"

    def apply(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def to_json(self) -> dict:
        return {"@vertex": self.kind, **self._extra_json()}

    def _extra_json(self) -> dict:
        return {}


class MergeVertex(GraphVertex):
    """Concatenation along the last (channel) axis."""

    kind = "merge"

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=-1)

    def output_shape(self, input_shapes):
        first = tuple(input_shapes[0])
        return first[:-1] + (sum(s[-1] for s in input_shapes),)


class ElementWiseVertex(GraphVertex):
    """Add, product, subtract (two inputs), average or max of inputs of
    one shape, folded left to right as JAX folds them."""

    kind = "elementwise"
    OPS = ("add", "product", "subtract", "average", "max")

    def __init__(self, op: str = "add"):
        op = op.lower()
        assert op in self.OPS, op
        self.op = op

    def apply(self, inputs):
        if self.op == "subtract":
            assert len(inputs) == 2
            return inputs[0] - inputs[1]
        if self.op == "average":
            return sum(inputs) / float(len(inputs))
        out = inputs[0]
        for x in inputs[1:]:
            if self.op == "add":
                out = out + x
            elif self.op == "product":
                out = out * x
            else:
                out = torch.maximum(out, x)
        return out

    def _extra_json(self):
        return {"op": self.op}


class SubsetVertex(GraphVertex):
    """Channels ``[from_idx, to_idx]``, both ends included."""

    kind = "subset"

    def __init__(self, from_idx: int = 0, to_idx: int = 0):
        self.from_idx = int(from_idx)
        self.to_idx = int(to_idx)

    def apply(self, inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_shape(self, input_shapes):
        s = tuple(input_shapes[0])
        return s[:-1] + (self.to_idx - self.from_idx + 1,)

    def _extra_json(self):
        return {"from_idx": self.from_idx, "to_idx": self.to_idx}


class StackVertex(GraphVertex):
    """n inputs of [B, ...] stacked along the batch: [n*B, ...]."""

    kind = "stack"

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=0)


class UnstackVertex(GraphVertex):
    """Part ``from_idx`` of ``stack_size`` equal batch parts."""

    kind = "unstack"

    def __init__(self, from_idx: int = 0, stack_size: int = 1):
        self.from_idx = int(from_idx)
        self.stack_size = int(stack_size)

    def apply(self, inputs):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def _extra_json(self):
        return {"from_idx": self.from_idx, "stack_size": self.stack_size}


class ScaleVertex(GraphVertex):
    kind = "scale"

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)

    def apply(self, inputs):
        return inputs[0] * self.scale

    def _extra_json(self):
        return {"scale": self.scale}


class ShiftVertex(GraphVertex):
    kind = "shift"

    def __init__(self, shift: float = 0.0):
        self.shift = float(shift)

    def apply(self, inputs):
        return inputs[0] + self.shift

    def _extra_json(self):
        return {"shift": self.shift}


class L2NormalizeVertex(GraphVertex):
    """``x / (||x||_2 + eps)`` over every axis but the batch."""

    kind = "l2normalize"

    def __init__(self, eps: float = 1e-8):
        self.eps = float(eps)

    def apply(self, inputs):
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        norm = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / (norm + self.eps)

    def _extra_json(self):
        return {"eps": self.eps}


class L2Vertex(GraphVertex):
    """``sqrt(sum((a - b)^2) + eps)`` of two inputs over every axis but
    the batch: [B, 1]."""

    kind = "l2"

    def __init__(self, eps: float = 1e-8):
        self.eps = float(eps)

    def apply(self, inputs):
        a, b = inputs
        axes = tuple(range(1, a.ndim))
        d = a - b
        return torch.sqrt(torch.sum(d * d, dim=axes) + self.eps)[:, None]

    def output_shape(self, input_shapes):
        return (1,)

    def _extra_json(self):
        return {"eps": self.eps}


class ReshapeVertex(GraphVertex):
    """Every axis but the batch reshaped to ``shape``."""

    kind = "reshape"

    def __init__(self, shape: Sequence[int] = ()):
        self.shape = tuple(int(s) for s in shape)

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + self.shape)

    def output_shape(self, input_shapes):
        return self.shape

    def _extra_json(self):
        return {"shape": list(self.shape)}


class PreprocessorVertex(GraphVertex):
    """A named shape preprocessor: ``cnn_to_ff`` (flatten, NHWC order),
    ``rnn_last_step`` ([B, T, C] to the last step's [B, C]) or
    ``ff_to_rnn`` ([B, C] to [B, 1, C])."""

    kind = "preprocessor"

    def __init__(self, op: str = "cnn_to_ff"):
        self.op = op

    def apply(self, inputs):
        x = inputs[0]
        if self.op == "cnn_to_ff":
            return x.reshape(x.shape[0], -1)
        if self.op == "rnn_last_step":
            return x[:, -1, :]
        if self.op == "ff_to_rnn":
            return x[:, None, :]
        raise ValueError(self.op)

    def output_shape(self, input_shapes):
        s = tuple(input_shapes[0])
        if self.op == "cnn_to_ff":
            return (int(np.prod(s)),)
        if self.op == "rnn_last_step":
            return (s[-1],)
        if self.op == "ff_to_rnn":
            return (1,) + s
        raise ValueError(self.op)

    def _extra_json(self):
        return {"op": self.op}


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _load_class(path: str) -> type:
    mod, _, qual = path.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


class SameDiffLambdaVertex(GraphVertex):
    """A vertex whose forward is a SameDiff graph (``fn=`` or a
    subclass's ``define_vertex``). Its configuration and JSON are JAX's;
    running it needs ``autodiff/samediff``, which is not ported."""

    kind = "samediff_lambda_vertex"

    def __init__(self, fn=None):
        self._fn = fn

    def define_vertex(self, sd, *inputs):
        if self._fn is not None:
            return self._fn(sd, *inputs)
        raise NotImplementedError("pass fn= or override define_vertex")

    def apply(self, inputs):
        _not_ported("SameDiffLambdaVertex (it needs autodiff/samediff)",
                    "15")

    def output_shape(self, input_shapes):
        _not_ported("SameDiffLambdaVertex (it needs autodiff/samediff)",
                    "15")

    def _extra_json(self):
        if type(self) is not SameDiffLambdaVertex:
            return {"cls": _class_path(self)}
        return {"cls": None}


VERTEX_REGISTRY: Dict[str, type] = {
    c.kind: c for c in (MergeVertex, ElementWiseVertex, SubsetVertex,
                        StackVertex, UnstackVertex, ScaleVertex, ShiftVertex,
                        L2NormalizeVertex, L2Vertex, ReshapeVertex,
                        PreprocessorVertex, SameDiffLambdaVertex)
}


def vertex_from_json(d: dict) -> GraphVertex:
    """A vertex from its ``to_json`` dict (either package's)."""
    d = dict(d)
    kind = d.pop("@vertex")
    cls_path = d.pop("cls", None)
    if cls_path:
        return _load_class(cls_path)(**d)
    if kind == "samediff_lambda_vertex":
        raise ValueError("anonymous SameDiff lambda vertices (fn=...) are "
                         "not serializable: subclass SameDiffLambdaVertex")
    return VERTEX_REGISTRY[kind](**d)


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("name", "layer", "vertex", "inputs")

    def __init__(self, name, layer=None, vertex=None, inputs=()):
        self.name = name
        self.layer = layer
        self.vertex = vertex
        self.inputs = list(inputs)


class ComputationGraphConfiguration:
    """The DAG (nodes by name, each a layer or a vertex over named
    inputs), its inputs and outputs with their input types, and the
    network-wide settings of ``MultiLayerConfiguration``."""

    def __init__(self, nodes: Dict[str, _Node], graph_inputs: List[str],
                 graph_outputs: List[str], input_types: Dict[str, InputType],
                 seed: int = 12345, updater=None,
                 defaults: Optional[dict] = None,
                 max_grad_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None,
                 tbptt_fwd_length: int = 0, dtype: str = "float",
                 remat: bool = False):
        self.nodes = nodes
        self.graph_inputs = graph_inputs
        self.graph_outputs = graph_outputs
        self.input_types = input_types
        self.seed = int(seed)
        self.updater = U.get(updater) if updater is not None else U.Sgd(0.1)
        self.defaults = defaults or {}
        self.max_grad_norm = max_grad_norm
        self.grad_clip_value = grad_clip_value
        self.tbptt_fwd_length = tbptt_fwd_length
        self.dtype = dtype
        self.remat = bool(remat)

    def topo_order(self) -> List[str]:
        """Kahn's order, the ready nodes of each round in sorted name
        order; a cycle or a missing input raises ``ValueError``."""
        order: List[str] = []
        seen = set(self.graph_inputs)
        pending = dict(self.nodes)
        while pending:
            ready = [n for n, node in pending.items()
                     if all(i in seen for i in node.inputs)]
            if not ready:
                raise ValueError(f"graph has a cycle or missing input: "
                                 f"{sorted(pending)}")
            for n in sorted(ready):
                order.append(n)
                seen.add(n)
                del pending[n]
        return order

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "updater": self.updater.to_json(),
            "defaults": MultiLayerConfiguration._defaults_to_json(
                self.defaults),
            "inputs": self.graph_inputs,
            "outputs": self.graph_outputs,
            "input_types": {k: v.to_json()
                            for k, v in self.input_types.items()},
            "max_grad_norm": self.max_grad_norm,
            "grad_clip_value": self.grad_clip_value,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "dtype": self.dtype,
            "remat": self.remat,
            "nodes": [{
                "name": n.name, "inputs": n.inputs,
                **({"layer": n.layer.to_json()} if n.layer is not None
                   else {}),
                **({"vertex": n.vertex.to_json()} if n.vertex is not None
                   else {}),
            } for n in self.nodes.values()],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        """A configuration from either package's JSON."""
        d = json.loads(s)
        nodes = {}
        for nd in d["nodes"]:
            layer = layer_from_json(nd["layer"]) if "layer" in nd else None
            vertex = (vertex_from_json(nd["vertex"]) if "vertex" in nd
                      else None)
            nodes[nd["name"]] = _Node(nd["name"], layer, vertex, nd["inputs"])
        defaults = d.get("defaults", {})
        if isinstance(defaults.get("updater"), dict):
            defaults["updater"] = U.get(defaults["updater"])
        return ComputationGraphConfiguration(
            nodes=nodes, graph_inputs=d["inputs"], graph_outputs=d["outputs"],
            input_types={k: InputType.from_json(v)
                         for k, v in d["input_types"].items()},
            seed=d.get("seed", 12345),
            updater=U.get(d["updater"]) if d.get("updater") else None,
            defaults=defaults, max_grad_norm=d.get("max_grad_norm"),
            grad_clip_value=d.get("grad_clip_value"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 0),
            dtype=d.get("dtype", "float"),
            remat=d.get("remat", False))


class GraphBuilder:
    """The fluent DAG builder: ``add_inputs``, ``set_input_types``,
    ``add_layer``, ``add_vertex``, ``set_outputs``, ``tbptt`` and
    ``build``."""

    def __init__(self, base=None):
        self._base = base
        self._nodes: Dict[str, _Node] = {}
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._input_types: Dict[str, InputType] = {}
        self._tbptt = 0

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        for name, t in zip(self._inputs, types):
            self._input_types[name] = t
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str
                  ) -> "GraphBuilder":
        layer.name = layer.name or name
        self._nodes[name] = _Node(name, layer=layer, inputs=inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str
                   ) -> "GraphBuilder":
        self._nodes[name] = _Node(name, vertex=vertex, inputs=inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def tbptt(self, fwd: int) -> "GraphBuilder":
        self._tbptt = int(fwd)
        return self

    def build(self) -> ComputationGraphConfiguration:
        b = self._base
        kw = {}
        if b is not None:
            kw = dict(seed=b._seed, updater=b._updater, defaults=b._defaults(),
                      max_grad_norm=b._max_grad_norm,
                      grad_clip_value=b._grad_clip_value, dtype=b._dtype,
                      remat=b._remat)
        return ComputationGraphConfiguration(
            nodes=self._nodes, graph_inputs=self._inputs,
            graph_outputs=self._outputs, input_types=self._input_types,
            tbptt_fwd_length=self._tbptt, **kw)


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

def _draws(layer) -> bool:
    """Whether a layer (or a layer it wraps) draws from its key in
    training: dropout or a noise scheme on its input, or weight noise."""
    if layer is None:
        return False
    if layer.dropout or layer.weight_noise is not None:
        return True
    return any(_draws(getattr(layer, a, None))
               for a in ("layer", "layer_bwd", "attn"))


def _split_row(key, i: int):
    """Row ``i`` of ``split(key, n)`` for any n > i: one hash."""
    return R.threefry2x32(key[0], key[1], i >> 32, i & 0xFFFFFFFF)


def _ndim(x) -> int:
    return getattr(x, "ndim", 0)


class ComputationGraph:
    """A DAG network with ``fit``, ``output``, ``score`` and
    ``evaluate``; the public surface mirrors the JAX class."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._order = conf.topo_order()
        self._params: Optional[Params] = None
        self._net_state: Params = {}
        self._opt_state: Optional[Dict[str, Any]] = None
        self._updaters: Dict[str, Any] = {}
        self._layers_meta: Dict[str, dict] = {}
        self._step = 0
        self._epoch = 0
        self.listeners: List = []
        self._last_loss: Optional[torch.Tensor] = None
        self._rng = R.PRNGKey(conf.seed)
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        consumed = {i for n in conf.nodes.values() for i in n.inputs}
        # output nodes no other node reads: the loss scores their input
        # node's activation, so the training forward skips them
        self._loss_only = frozenset(n for n in conf.graph_outputs
                                    if n not in consumed)

    # -- init ----------------------------------------------------------
    def init(self, dtype=torch.float32) -> "ComputationGraph":
        """Build every node on its first input's shape, draw its params
        in ``dtype`` from its key of ``split(PRNGKey(seed), len(order) +
        1)`` (JAX's params from the same seed), its state, its updater
        and its L1/L2 coefficients."""
        return self._init(dtype)

    def _init(self, dtype, params: Optional[Params] = None):
        """:meth:`init`, taking ``params`` in place of the draw when they
        are given. The draws run on the graph's device."""
        if not dtype.is_floating_point:
            raise ValueError(f"params need a floating dtype, got {dtype}")
        conf = self.conf
        shapes: Dict[str, Tuple[int, ...]] = {}
        for name in conf.graph_inputs:
            if name not in conf.input_types:
                raise ValueError(f"input {name} needs an InputType")
            shapes[name] = tuple(conf.input_types[name].shape)
        key0 = self._rng
        self._rng = _split_row(key0, 0)
        drawn: Params = {}
        state: Params = {}
        self._updaters, self._layers_meta = {}, {}
        with torch.device(self.device):
            for i, name in enumerate(self._order):
                node = conf.nodes[name]
                in_shapes = [shapes[x] for x in node.inputs]
                if node.layer is None:
                    shapes[name] = tuple(node.vertex.output_shape(in_shapes))
                    continue
                layer = node.layer
                layer.build(in_shapes[0], conf.defaults)
                p = (layer.init_params(_split_row(key0, i + 1), dtype)
                     if params is None else None)
                if p:
                    drawn[name] = p
                st = layer.init_state()
                if st:
                    state[name] = st
                shapes[name] = tuple(layer.output_shape(in_shapes[0]))
                self._updaters[name] = (layer.updater
                                        if layer.updater is not None
                                        else conf.updater)
                self._layers_meta[name] = {
                    "l1": layer.l1, "l2": layer.l2, "l1_bias": layer.l1_bias,
                    "l2_bias": layer.l2_bias,
                    "bias_params": frozenset(layer.bias_param_names())}
        self._shapes = shapes
        self.set_params(drawn if params is None else params)
        self.set_net_state(state)
        self._opt_state = {name: self._updaters[name].init_state(p)
                           for name, p in self._params.items()}
        self._step = 0
        return self

    # -- forward -------------------------------------------------------
    @staticmethod
    def _node_mask(node, acts, macts):
        """The feature mask a node takes from its inputs' (JAX's
        propagation rules)."""
        seq_masks, any_unmasked_seq = [], False
        for x in node.inputs:
            mx = macts.get(x)
            if mx is not None:
                seq_masks.append(mx)
            elif _ndim(acts[x]) == 3:
                any_unmasked_seq = True
        vkind = getattr(node.vertex, "kind", None)
        if vkind == "stack" and seq_masks:
            # the stack concatenates the batch: so do the masks, ones
            # standing in for an unmasked input
            parts = []
            for x in node.inputs:
                mx = macts.get(x)
                if mx is None:
                    mx = torch.ones((acts[x].shape[0],)
                                    + tuple(seq_masks[0].shape[1:]),
                                    dtype=seq_masks[0].dtype,
                                    device=seq_masks[0].device)
                parts.append(mx)
            return torch.cat(parts, dim=0)
        if vkind == "unstack" and seq_masks:
            v = node.vertex
            step = seq_masks[0].shape[0] // v.stack_size
            return seq_masks[0][v.from_idx * step:(v.from_idx + 1) * step]
        if any_unmasked_seq or not seq_masks:
            return None
        fm = seq_masks[0]
        for m2 in seq_masks[1:]:
            fm = torch.maximum(fm, m2)
        return fm

    def _forward(self, params: Params, net_state: Params,
                 inputs: Dict[str, torch.Tensor], train: bool, rng,
                 fmask=None, stop_at: Optional[str] = None, carries=None,
                 skip=frozenset()):
        """Evaluate the order over a dict of activations. Returns (acts,
        new state), or (acts, new state, new carries) when ``carries``
        is passed (TBPTT). ``fmask`` is one [B, T] mask for every input
        or a dict by input name; nodes in ``skip`` are not evaluated."""
        conf = self.conf
        acts: Dict[str, Any] = dict(inputs)
        if isinstance(fmask, dict):
            macts: Dict[str, Any] = {k: fmask.get(k) for k in inputs}
        else:
            macts = {k: fmask for k in inputs}
        new_state = dict(net_state)
        new_carries: Dict[str, Any] = {}
        remat = conf.remat and train
        for i, name in enumerate(self._order):
            if name in skip:
                continue
            node = conf.nodes[name]
            ins = [acts[x] for x in node.inputs]
            fm = self._node_mask(node, acts, macts)
            layer = node.layer
            if layer is None:
                act = node.vertex.apply(ins)
            else:
                p = params.get(name, {})
                s = net_state.get(name, {})
                r = (_split_row(rng, i) if rng is not None and train
                     and _draws(layer) else None)
                if getattr(layer, "derives_mask", False):
                    derived = layer.derive_mask(ins[0])
                    if derived is not None:
                        fm = derived if fm is None else fm * derived
                if layer.weight_noise is not None:
                    p = layer._maybe_weight_noise(p, train, r)
                if layer.is_rnn:
                    m = fm if ins[0].ndim == 3 else None
                    carry = carries.get(name) if carries is not None \
                        else None
                    if carry is None:
                        x0 = ins[0]
                        carry = layer.init_carry(
                            x0.shape[0], x0.dtype if x0.is_floating_point()
                            else torch.float32, x0.device)

                    def seq(p_, a_, s_, c_, m_, _l=layer, _r=r):
                        return _l.apply_seq(p_, a_, s_, train, _r, c_, m_)
                    if remat:
                        act, s2, c2 = checkpoint(seq, p, ins[0], s, carry, m,
                                                 use_reentrant=False)
                    else:
                        act, s2, c2 = seq(p, ins[0], s, carry, m)
                    new_carries[name] = c2
                elif layer.wants_mask:
                    m = fm if ins[0].ndim == 3 else None
                    act, s2 = layer.apply_with_mask(p, ins[0], s, train, r, m)
                elif remat and layer.has_params:
                    act, s2 = checkpoint(
                        lambda p_, a_, s_, _l=layer, _r=r:
                        _l.apply(p_, a_, s_, train, _r),
                        p, ins[0], s, use_reentrant=False)
                else:
                    act, s2 = layer.apply(p, ins[0], s, train, r)
                if s:
                    new_state[name] = s2
            acts[name] = act
            # the mask rides while the activation keeps a time axis
            macts[name] = fm if _ndim(act) == 3 else None
            if stop_at is not None and name == stop_at:
                break
        if carries is not None:
            return acts, new_state, new_carries
        return acts, new_state

    def _loss_fn(self, params: Params, net_state: Params, inputs, labels,
                 masks, train: bool, rng=None, carries=None):
        """The sum of the output layers' losses (each on its input
        node's activation) plus the L1/L2 terms, and the layers' new
        state; with ``carries``, (loss, (new state, new carries))."""
        r_fwd = r_out = None
        if rng is not None:
            keys = R.split(rng)
            r_fwd, r_out = R.key_at(keys, 0), R.key_at(keys, 1)
        cdt = compute_dtype(self.conf.dtype)
        params_c = cast_params_for_compute(params, set(self.conf.graph_outputs),
                                           cdt)
        inputs_c = {k: cast_input_for_compute(v, cdt)
                    for k, v in inputs.items()}
        fwd = self._forward(params_c, net_state, inputs_c, train, r_fwd,
                            fmask=self._fmask_from(masks), carries=carries,
                            skip=self._loss_only)
        acts, new_state = fwd[0], fwd[1]
        total = 0.0
        for out_name in self.conf.graph_outputs:
            node = self.conf.nodes[out_name]
            feats = cast_feats_to_f32(acts[node.inputs[0]])
            m = None if masks is None else masks.get(out_name)
            total = total + node.layer.compute_loss(
                params.get(out_name, {}), feats, labels[out_name], m,
                train=train, rng=r_out)
        loss = total + _regularization_penalty(params, self._layers_meta)
        if carries is not None:
            return loss, (new_state, fwd[2])
        return loss, new_state

    # -- the train step ------------------------------------------------
    def _grads(self, inputs, labels, masks, rng, carries=None):
        """Loss, gradients (zeros for a param the loss does not reach),
        the layers' new state and the new carries of one batch on the
        device, from the live params."""
        params = self._params
        keys = [(k, n) for k, p in params.items() for n in p]
        with torch.enable_grad():
            loss, aux = self._loss_fn(params, self._net_state, inputs,
                                      labels, masks, True, rng, carries)
            leaves = torch.autograd.grad(
                loss, [params[k][n] for k, n in keys], allow_unused=True) \
                if keys and loss.requires_grad else [None] * len(keys)
        grads: Params = {k: {} for k in params}
        for (k, n), g in zip(keys, leaves):
            grads[k][n] = torch.zeros_like(params[k][n]) if g is None else g
        new_state, new_carries = aux if carries is not None else (aux, None)
        return loss.detach(), grads, new_state, new_carries

    def apply_gradients(self, grads: Params, new_state: Params = None):
        """The step's second half: clip, each node's updater at the
        current step, ``p - u`` (in place for f32 leaves), the node's
        constraints, the layers' new state copied into the live tensors,
        and the step counted."""
        grads = _clip_grads(grads, self.conf.max_grad_norm,
                            self.conf.grad_clip_value)
        with torch.no_grad():
            for key, p in self._params.items():
                self._opt_state[key], upd = self._updaters[key].apply(
                    self._opt_state[key], grads[key], self._step)
                for n, t in p.items():
                    p[n] = _subtract(t, upd[n])
                layer = self.conf.nodes[key].layer
                if layer is not None and layer.constraints:
                    for n, t in apply_constraints(
                            layer.constraints, p,
                            layer.bias_param_names()).items():
                        if t is not p[n]:
                            p[n].copy_(t)
            # in place, so a captured graph keeps reading the live stats
            for key, st in (new_state or {}).items():
                for n, t in st.items():
                    self._net_state[key][n].copy_(t)
        self._step += 1

    def _init_carries(self, batch: int, dtype=torch.float32, device=None):
        """Zero carries of every recurrent node, by name."""
        if not dtype.is_floating_point:
            dtype = torch.float32
        return {name: self.conf.nodes[name].layer.init_carry(
                    batch, dtype, device or self.device)
                for name in self._order
                if self.conf.nodes[name].layer is not None
                and self.conf.nodes[name].layer.is_rnn}

    def _fit_tbptt(self, inputs, labels, masks, tbptt: int):
        """Truncated BPTT over one batch: every sequence input and
        sequence label padded to the longest T (zero mask over the pad),
        then chunks of ``tbptt`` steps, each one train step from the
        carries the last chunk left (detached at the edge) under a key
        split off the chain, counting one step a chunk. Returns the last
        chunk's loss."""
        seq_ins = [k for k, v in inputs.items() if v.ndim == 3]
        T = max(inputs[k].shape[1] for k in seq_ins)
        B = next(iter(inputs.values())).shape[0]
        masks = dict(masks) if masks else {}
        inputs = dict(inputs)
        pad_t = torch.nn.functional.pad
        for k in seq_ins:
            Tk = inputs[k].shape[1]
            if k not in masks:
                masks[k] = torch.ones((B, Tk), dtype=inputs[k].dtype,
                                      device=inputs[k].device)
            if Tk < T:
                inputs[k] = pad_t(inputs[k], (0, 0, 0, T - Tk))
                masks[k] = pad_t(masks[k], (0, T - Tk))
        labels = dict(labels)
        for out_name in self.conf.graph_outputs:
            y = labels.get(out_name)
            if y is not None and _ndim(y) == 3:
                Ty = y.shape[1]
                if out_name not in masks:
                    masks[out_name] = torch.ones((B, Ty), dtype=y.dtype,
                                                 device=y.device)
                if Ty < T:
                    labels[out_name] = pad_t(y, (0, 0, 0, T - Ty))
                    masks[out_name] = pad_t(masks[out_name], (0, T - Ty))
        carries = self._init_carries(B, inputs[seq_ins[0]].dtype)
        loss = None
        for t0 in range(0, T, tbptt):
            def chunk(v):
                c = v[:, t0:t0 + tbptt]
                pad = tbptt - c.shape[1]
                if pad:
                    c = pad_t(c, (0, 0) * (c.ndim - 2) + (0, pad))
                return c
            ic = {k: chunk(v) if v.ndim == 3 else v
                  for k, v in inputs.items()}
            lc = {k: chunk(v) if _ndim(v) == 3 else v
                  for k, v in labels.items()}
            mc = {k: chunk(v) if _ndim(v) >= 2 and v.shape[1] == T else v
                  for k, v in masks.items()}
            keys = R.split(self._rng)
            self._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
            carries = {k: _detach(c) for k, c in carries.items()}
            loss, grads, new_state, carries = self._grads(ic, lc, mc, sub,
                                                          carries)
            self.apply_gradients(grads, new_state)
        return loss

    # -- public API ----------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    def _by_name(self, data, names) -> Dict[str, torch.Tensor]:
        if isinstance(data, dict):
            return {k: self._tensor(v) for k, v in data.items()}
        if isinstance(data, (list, tuple)):
            return {n: self._tensor(v) for n, v in zip(names, data)}
        return {names[0]: self._tensor(data)}

    def _as_inputs(self, data) -> Dict[str, torch.Tensor]:
        return self._by_name(data, self.conf.graph_inputs)

    def _as_labels(self, labels) -> Dict[str, torch.Tensor]:
        return self._by_name(labels, self.conf.graph_outputs)

    def _as_masks(self, m):
        if m is None:
            return None
        return self._by_name(m, self.conf.graph_outputs)

    def _fmask_from(self, masks):
        """The feature masks of a masks dict: only the entries keyed by
        an input name (a mask keyed by an output is a label mask)."""
        if not masks:
            return None
        keyed = {n: masks[n] for n in self.conf.graph_inputs if n in masks}
        return keyed or None

    @staticmethod
    def _unpack(item):
        if isinstance(item, tuple) and len(item) >= 2:
            return item[0], item[1], item[2] if len(item) > 2 else None
        return (item.features, item.labels,
                getattr(item, "labels_mask", None))

    def fit(self, data, labels=None, epochs: int = 1):
        """``fit(x, y)`` (arrays, lists or dicts by name), or ``fit(it)``
        over an iterator of ``(x, y[, masks])`` tuples or DataSet-like
        items, for ``epochs`` passes."""
        if self._params is None:
            self.init()
        if labels is not None:
            iterator = [(data, labels, None)]
        else:
            iterator = data if hasattr(data, "reset") or isinstance(
                data, (list, tuple)) else list(data)
        tbptt = self.conf.tbptt_fwd_length
        for _ in range(epochs):
            for item in iterator:
                x, y, m = self._unpack(item)
                t0 = time.perf_counter()
                inputs = self._as_inputs(x)
                labs = self._as_labels(y)
                masks = self._as_masks(m)
                seq_t = [v.shape[1] for v in inputs.values() if v.ndim == 3]
                if tbptt and seq_t and max(seq_t) > tbptt:
                    self._last_loss = self._fit_tbptt(inputs, labs, masks,
                                                      tbptt)
                else:
                    keys = R.split(self._rng)
                    self._rng, sub = R.key_at(keys, 0), R.key_at(keys, 1)
                    loss, grads, new_state, _ = self._grads(inputs, labs,
                                                            masks, sub)
                    self.apply_gradients(grads, new_state)
                    self._last_loss = loss
                dur = time.perf_counter() - t0
                for lst in self.listeners:
                    lst.iteration_done(self, self._step, self._epoch)
                    if hasattr(lst, "on_timing"):
                        lst.on_timing(self, dur,
                                      next(iter(inputs.values())).shape[0])
            self._epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def output(self, *data, train: bool = False, mask=None):
        """The outputs' activations, without gradients or dropout: one
        tensor for a single-output graph, else a list in output order.
        Takes one array (single input), arrays in input order, or a dict
        by input name; ``mask`` is the [B, T] feature mask, bare for a
        single-input graph or a dict by input name."""
        if self._params is None:
            self.init()
        if mask is not None:
            if isinstance(mask, dict):
                mask = self._fmask_from(mask)
            elif len(self.conf.graph_inputs) > 1:
                raise ValueError(
                    "a bare feature mask on a multi-input "
                    "ComputationGraph is ambiguous: pass a dict keyed by "
                    "input name")
        if len(data) == 1 and isinstance(data[0], (dict, list, tuple)):
            inputs = self._as_inputs(data[0])
        else:
            inputs = self._as_inputs(list(data))
        if isinstance(mask, dict):
            mask = {k: self._tensor(v) for k, v in mask.items()}
        elif mask is not None:
            mask = self._tensor(mask)
        with torch.no_grad():
            acts, _ = self._forward(self._params, self._net_state, inputs,
                                    train, None, fmask=mask)
        outs = [acts[n] for n in self.conf.graph_outputs]
        return outs[0] if len(outs) == 1 else outs

    def feed_forward(self, data, train: bool = False) -> Dict[str, Any]:
        """Every node's activation (and the inputs), by name."""
        if self._params is None:
            self.init()
        with torch.no_grad():
            return self._forward(self._params, self._net_state,
                                 self._as_inputs(data), train, None)[0]

    @property
    def score_(self) -> float:
        """Last minibatch loss (synchronizes with the device)."""
        return float("nan") if self._last_loss is None \
            else float(self._last_loss)

    def score(self, data, labels) -> float:
        """The loss (L1/L2 terms included) on one batch, in inference
        mode."""
        with torch.no_grad():
            loss, _ = self._loss_fn(self._params, self._net_state,
                                    self._as_inputs(data),
                                    self._as_labels(labels), None, False)
        return float(loss)

    def evaluate(self, iterator):
        """Classification evaluation of the first output over an
        iterator of ``(x, y[, masks])`` items: an ``eval.Evaluation``."""
        from ...eval import Evaluation
        ev = Evaluation()
        for item in iterator:
            x, y, _ = self._unpack(item)
            out = self.output(x)
            if isinstance(out, list):
                out = out[0]
                y = y[0] if isinstance(y, (list, tuple)) else y
            ev.eval(np.asarray(y), out.float().cpu().numpy(), None)
        return ev

    # -- state -----------------------------------------------------------
    def num_params(self) -> int:
        return sum(int(t.numel()) for p in self._params.values()
                   for t in p.values())

    def params(self) -> Params:
        return self._params

    def set_params(self, params: Params):
        """Take ``{node: {name: tensor}}``: the tensors move to the
        device as new leaves that require grad, f32 unless they are half
        (bf16 or fp16) tensors, which keep their dtype. The updater
        state is kept, as in JAX."""
        self._params = {
            k: {n: t.detach().to(self.device, _param_dtype(t))
                .clone().requires_grad_(True) for n, t in p.items()}
            for k, p in params.items()}

    def get_net_state(self) -> Params:
        """The layers' state (batch norm's running ``mean``/``var``)."""
        return self._net_state

    def set_net_state(self, state: Params):
        """Take layer state in the layout of :meth:`get_net_state`
        (tensors move to the device as f32 copies)."""
        self._net_state = {
            k: {n: t.detach().to(self.device, torch.float32).clone()
                for n, t in st.items()} for k, st in state.items()}

    def get_updater_state(self):
        return self._opt_state

    def set_updater_state(self, state):
        """Take updater state in the layout of
        :meth:`get_updater_state` (tensors move to the device, f32 but
        for half leaves)."""
        def to(x):
            if isinstance(x, dict):
                return {k: to(v) for k, v in x.items()}
            return x.detach().to(self.device, _param_dtype(x)).clone()
        self._opt_state = to(state)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def summary(self) -> str:
        """JAX's table: each node's type, output shape and params, then
        the total."""
        if self._params is None:
            self.init()
        lines = ["=" * 78,
                 f"{'name':<26}{'type':<24}{'out shape':<18}{'params':<10}",
                 "-" * 78]
        for name in self._order:
            node = self.conf.nodes[name]
            t = type(node.layer or node.vertex).__name__
            n = node.layer.n_params() if node.layer else 0
            lines.append(f"{name:<26}{t:<24}"
                         f"{str(self._shapes.get(name)):<18}{n:<10}")
        lines.append("-" * 78)
        lines.append(f"Total params: {self.num_params()}")
        lines.append("=" * 78)
        return "\n".join(lines)

    def clone(self, device=None) -> "ComputationGraph":
        """A copy on ``device`` (this graph's by default) built from the
        configuration's JSON, with a copy of the params and the layer
        state and, as in JAX, a fresh updater state and key chain."""
        g = ComputationGraph(
            ComputationGraphConfiguration.from_json(self.conf.to_json()),
            device=self.device if device is None else device)
        if self._params is not None:
            g._init(torch.float32, self._params)
            g.set_net_state(self._net_state)
        return g

    # -- layerwise pretraining -----------------------------------------
    def pretrain(self, iterator, epochs: int = 1):
        """Pretrain every pretrainable node in the topological order on
        the inference-mode activation of its input node. A generator is
        read once into a list."""
        if self._params is None:
            self.init()
        if not hasattr(iterator, "reset") and \
                not isinstance(iterator, (list, tuple)):
            iterator = list(iterator)
        for name in self._order:
            layer = self.conf.nodes[name].layer
            if layer is not None and layer.is_pretrain_layer:
                self.pretrain_node(name, iterator, epochs=epochs)
        return self

    def pretrain_node(self, name: str, iterator, epochs: int = 1):
        """Pretrain node ``name`` on its unsupervised loss over its
        input node's activation (the graph evaluated up to that node in
        inference mode); only its params and updater state move
        (:func:`..multilayer.pretrain_steps`)."""
        if self._params is None:
            self.init()
        node = self.conf.nodes[name]
        layer = node.layer
        if layer is None or not layer.is_pretrain_layer:
            raise ValueError(f"node {name!r} is not pretrainable")
        in_node = node.inputs[0]

        def features(x):
            inputs = self._as_inputs(x)
            if in_node in inputs:      # nothing to evaluate before it
                return inputs[in_node]
            return self._forward(self._params, self._net_state, inputs,
                                 False, None, stop_at=in_node)[0][in_node]
        pretrain_steps(self, name, layer, self._updaters[name], iterator,
                       epochs, features)
        return self
