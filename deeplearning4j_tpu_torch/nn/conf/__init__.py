"""Configuration DSL (counterpart of ``deeplearning4j_tpu/nn/conf``):
the fluent builder, the list builder and the configuration they
produce.

    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(EmbeddingSequenceLayer(n_in=32000, n_out=512))
            .layer(TransformerEncoderLayer(n_heads=8, causal=True))
            .layer(RnnOutputLayer(n_out=32000, loss="mcxent"))
            .input_type_recurrent(1, timesteps=1024).build())

``tbptt(fwd)`` trains sequences in chunks of ``fwd`` steps,
``remat(True)`` recomputes each layer's forward in the backward,
``weight_noise`` and ``constrain_weights`` set the layers' defaults. A
half dtype (``data_type("bfloat16")``) trains under the bf16
mixed-precision policy (``nn/precision.py``). ``to_json`` gives the
JAX package's JSON text for the same configuration, and
``MultiLayerConfiguration.from_json`` reads either package's.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

from ... import learning as U
from ..layers import Layer, from_json as layer_from_json
from . import constraint as C
from . import weightnoise as WN

Shape = Tuple[int, ...]


class InputType:
    """Feed-forward ``(size,)``, recurrent ``(timesteps, size)``
    (timesteps -1 when unknown), image ``(height, width, channels)`` or
    volume ``(depth, height, width, channels)`` input, NHWC and NDHWC as
    in JAX. ``convolutional_flat`` images arrive
    flattened to [B, h*w*c] and the network reshapes them."""

    def __init__(self, kind: str, shape: Shape):
        self.kind = kind
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", (size,))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", (timesteps or -1, size))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", (height, width, channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType("cnnflat", (height, width, channels))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """NDHWC volumes, as in JAX."""
        return InputType("cnn3d", (depth, height, width, channels))

    def to_json(self):
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_json(d):
        return InputType(d["kind"], tuple(d["shape"]))


class MultiLayerConfiguration:
    """A layer stack with its seed, default updater and per-layer
    defaults, input type, gradient normalization and dtype."""

    def __init__(self, layers: List[Layer], seed: int = 12345,
                 updater=None, defaults: Optional[dict] = None,
                 input_type: Optional[InputType] = None,
                 tbptt_fwd_length: int = 0, tbptt_bwd_length: int = 0,
                 max_grad_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None,
                 dtype: str = "float", remat: bool = False):
        self.layers = layers
        self.seed = int(seed)
        self.updater = U.get(updater) if updater is not None else U.Sgd(0.1)
        self.defaults = defaults or {}
        self.input_type = input_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_bwd_length = tbptt_bwd_length
        self.max_grad_norm = max_grad_norm      # per-layer L2 clip
        self.grad_clip_value = grad_clip_value  # elementwise clip
        self.dtype = dtype
        # recompute each layer's forward in the backward instead of
        # keeping its activations
        self.remat = bool(remat)

    @staticmethod
    def _defaults_to_json(defaults: dict) -> dict:
        out = {}
        for k, v in defaults.items():
            if isinstance(v, list):
                out[k] = [x.to_json() if hasattr(x, "to_json") else x
                          for x in v]
            else:
                out[k] = v.to_json() if hasattr(v, "to_json") else v
        return out

    def to_json(self) -> str:
        """The JAX package's JSON text of this configuration."""
        return json.dumps({
            "seed": self.seed,
            "updater": self.updater.to_json(),
            "defaults": self._defaults_to_json(self.defaults),
            "input_type": (self.input_type.to_json() if self.input_type
                           else None),
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
            "max_grad_norm": self.max_grad_norm,
            "grad_clip_value": self.grad_clip_value,
            "dtype": self.dtype,
            "remat": self.remat,
            "layers": [l.to_json() for l in self.layers],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        """A configuration from :meth:`to_json`'s text (or the JAX
        package's)."""
        d = json.loads(s)
        defaults = d.get("defaults", {})
        if isinstance(defaults.get("updater"), dict):
            defaults["updater"] = U.get(defaults["updater"])
        return MultiLayerConfiguration(
            layers=[layer_from_json(ld) for ld in d["layers"]],
            seed=d.get("seed", 12345),
            updater=U.get(d["updater"]) if d.get("updater") else None,
            defaults=defaults,
            input_type=(InputType.from_json(d["input_type"])
                        if d.get("input_type") else None),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 0),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 0),
            max_grad_norm=d.get("max_grad_norm"),
            grad_clip_value=d.get("grad_clip_value"),
            dtype=d.get("dtype", "float"),
            remat=d.get("remat", False))


class ListBuilder:
    """Collects the layers and the input type."""

    def __init__(self, base: "NeuralNetConfiguration"):
        self._base = base
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._tbptt = (0, 0)

    def layer(self, layer: Layer) -> "ListBuilder":
        self._layers.append(layer)
        return self

    def input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_type_feed_forward(self, size: int) -> "ListBuilder":
        return self.input_type(InputType.feed_forward(size))

    def input_type_recurrent(self, size: int,
                             timesteps: Optional[int] = None
                             ) -> "ListBuilder":
        return self.input_type(InputType.recurrent(size, timesteps))

    def input_type_convolutional(self, h: int, w: int,
                                 c: int) -> "ListBuilder":
        return self.input_type(InputType.convolutional(h, w, c))

    def tbptt(self, fwd: int, bwd: Optional[int] = None) -> "ListBuilder":
        """Truncated BPTT over chunks of ``fwd`` timesteps (``bwd`` is
        recorded; as in JAX, the backward spans the same chunk)."""
        self._tbptt = (fwd, bwd if bwd is not None else fwd)
        return self

    def build(self) -> MultiLayerConfiguration:
        b = self._base
        return MultiLayerConfiguration(
            layers=self._layers, seed=b._seed, updater=b._updater,
            defaults=b._defaults(), input_type=self._input_type,
            tbptt_fwd_length=self._tbptt[0],
            tbptt_bwd_length=self._tbptt[1],
            max_grad_norm=b._max_grad_norm,
            grad_clip_value=b._grad_clip_value, dtype=b._dtype,
            remat=b._remat)


class NeuralNetConfiguration:
    """Fluent builder of the network-wide settings."""

    def __init__(self):
        self._seed = 12345
        self._updater = None
        self._weight_init = None
        self._activation = None
        self._l1 = 0.0
        self._l2 = 0.0
        self._dropout = 0.0
        self._weight_noise = None
        self._constraints = []
        self._max_grad_norm = None
        self._grad_clip_value = None
        self._remat = False
        # the JAX builder's default (its flags' dtype), so both write
        # the same JSON
        self._dtype = "float32"

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def updater(self, u):
        self._updater = U.get(u)
        return self

    def weight_init(self, w: str):
        self._weight_init = w
        return self

    def activation(self, a):
        self._activation = a
        return self

    def l1(self, v: float):
        self._l1 = float(v)
        return self

    def l2(self, v: float):
        self._l2 = float(v)
        return self

    def dropout(self, v):
        """The layers' default dropout: a drop probability, or a
        ``dropout.py`` scheme (Gaussian, alpha, spatial, noise)."""
        self._dropout = float(v) if isinstance(v, (int, float)) else v
        return self

    def weight_noise(self, wn):
        """The layers' default weight noise (``DropConnect``,
        ``WeightNoise`` or its dict)."""
        self._weight_noise = WN.get(wn)
        return self

    def constrain_weights(self, *constraints):
        """The layers' default constraints, applied after each update."""
        self._constraints = [C.get(c) for c in constraints]
        return self

    def gradient_normalization(self, max_norm: Optional[float] = None,
                               clip_value: Optional[float] = None):
        """``max_norm``: clip each layer's gradient to this L2 norm
        (ClipL2PerLayer); ``clip_value``: clip each element
        (ClipElementWiseAbsoluteValue)."""
        self._max_grad_norm = max_norm
        self._grad_clip_value = clip_value
        return self

    def remat(self, on: bool = True):
        """Recompute each layer's forward in the backward
        (``torch.utils.checkpoint``) instead of keeping its activations:
        less device memory for a second forward's work."""
        self._remat = bool(on)
        return self

    def data_type(self, dt: str):
        """The configuration's dtype: ``"float32"`` (the default) or
        ``"float"`` trains in f32; ``"bfloat16"``, ``"bf16"``, ``"half"``, ``"float16"`` and
        ``"fp16"`` under the bf16 mixed-precision policy."""
        self._dtype = dt
        return self

    def _defaults(self) -> dict:
        d = {}
        if self._weight_init is not None:
            d["weight_init"] = self._weight_init
        if self._activation is not None:
            d["activation"] = self._activation
        if self._updater is not None:
            d["updater"] = self._updater
        if self._l1:
            d["l1"] = self._l1
        if self._l2:
            d["l2"] = self._l2
        if self._dropout:
            d["dropout"] = self._dropout
        if self._weight_noise is not None:
            d["weight_noise"] = self._weight_noise
        if self._constraints:
            d["constraints"] = list(self._constraints)
        return d

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph_builder(self):
        """A :class:`~..graph.GraphBuilder` that builds a
        ``ComputationGraphConfiguration`` with these settings."""
        from ..graph import GraphBuilder
        return GraphBuilder(self)
