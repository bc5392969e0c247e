"""Configuration DSL (counterpart of ``deeplearning4j_tpu/nn/conf``):
the fluent builder, the list builder and the configuration they
produce.

    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(EmbeddingSequenceLayer(n_in=32000, n_out=512))
            .layer(TransformerEncoderLayer(n_heads=8, causal=True))
            .layer(RnnOutputLayer(n_out=32000, loss="mcxent"))
            .input_type_recurrent(1, timesteps=1024).build())

Settings the port cannot train with yet (TBPTT, remat) are recorded
here and refused by ``MultiLayerNetwork``; weight noise and weight
constraints raise here. A half dtype
(``data_type("bfloat16")``) trains under the bf16 mixed-precision
policy (``nn/precision.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ... import learning as U
from ..layers import Layer

Shape = Tuple[int, ...]


class InputType:
    """Feed-forward ``(size,)``, recurrent ``(timesteps, size)``
    (timesteps -1 when unknown) or image ``(height, width, channels)``
    input, NHWC as in JAX. ``convolutional_flat`` images arrive
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


class MultiLayerConfiguration:
    """A layer stack with its seed, default updater and per-layer
    defaults, input type, gradient normalization and dtype."""

    def __init__(self, layers: List[Layer], seed: int = 12345,
                 updater=None, defaults: Optional[dict] = None,
                 input_type: Optional[InputType] = None,
                 tbptt_fwd_length: int = 0,
                 max_grad_norm: Optional[float] = None,
                 grad_clip_value: Optional[float] = None,
                 dtype: str = "float", remat: bool = False):
        self.layers = layers
        self.seed = int(seed)
        self.updater = U.get(updater) if updater is not None else U.Sgd(0.1)
        self.defaults = defaults or {}
        self.input_type = input_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.max_grad_norm = max_grad_norm      # per-layer L2 clip
        self.grad_clip_value = grad_clip_value  # elementwise clip
        self.dtype = dtype
        self.remat = bool(remat)


class ListBuilder:
    """Collects the layers and the input type."""

    def __init__(self, base: "NeuralNetConfiguration"):
        self._base = base
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None

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

    def build(self) -> MultiLayerConfiguration:
        b = self._base
        return MultiLayerConfiguration(
            layers=self._layers, seed=b._seed, updater=b._updater,
            defaults=b._defaults(), input_type=self._input_type,
            max_grad_norm=b._max_grad_norm,
            grad_clip_value=b._grad_clip_value, dtype=b._dtype)


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
        self._max_grad_norm = None
        self._grad_clip_value = None
        self._dtype = "float"

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
        raise NotImplementedError("weight noise is not ported yet "
                                  "(ROADMAP.md queue A, item 11)")

    def constrain_weights(self, *constraints):
        raise NotImplementedError("weight constraints are not ported yet "
                                  "(ROADMAP.md queue A, item 11)")

    def gradient_normalization(self, max_norm: Optional[float] = None,
                               clip_value: Optional[float] = None):
        """``max_norm``: clip each layer's gradient to this L2 norm
        (ClipL2PerLayer); ``clip_value``: clip each element
        (ClipElementWiseAbsoluteValue)."""
        self._max_grad_norm = max_norm
        self._grad_clip_value = clip_value
        return self

    def data_type(self, dt: str):
        """The configuration's dtype: ``"float"`` (the default) trains in
        f32; ``"bfloat16"``, ``"bf16"``, ``"half"``, ``"float16"`` and
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
        return d

    def list(self) -> ListBuilder:
        return ListBuilder(self)
