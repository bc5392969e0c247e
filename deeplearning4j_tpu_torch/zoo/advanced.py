"""SqueezeNet, UNet, Xception and NASNet (counterpart of
``deeplearning4j_tpu/zoo/advanced.py``). SqueezeNet v1.1 is a graph of
fire modules at the JAX package's widths. UNet, Xception and NASNet
need ``Cropping2D``, ``Deconvolution2D`` and ``SeparableConvolution2D``
(``nn/layers/convolutional.py``), which come with the rest of
``nn/layers``; they raise until then."""
from __future__ import annotations

from ..nn import NeuralNetConfiguration
from ..nn.conf import InputType
from ..nn.graph import MergeVertex
from ..nn.layers import (ConvolutionLayer, DropoutLayer, GlobalPoolingLayer,
                         LossLayer, SubsamplingLayer)
from . import ZooModel
from .simple import _NotPorted


class SqueezeNet(ZooModel):
    """SqueezeNet v1.1: fire modules (a 1x1 squeeze, then 1x1 and 3x3
    expands merged on the channels), dropout, a 1x1 class conv, average
    pooling and a softmax loss."""

    name = "squeezenet"
    input_shape = (227, 227, 3)

    def __init__(self, num_classes: int = 1000, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def fire(name, inp, squeeze, expand):
            g.add_layer(f"{name}_sq", ConvolutionLayer(
                n_out=squeeze, kernel=(1, 1), activation="relu"), inp)
            g.add_layer(f"{name}_e1", ConvolutionLayer(
                n_out=expand, kernel=(1, 1), activation="relu"), f"{name}_sq")
            g.add_layer(f"{name}_e3", ConvolutionLayer(
                n_out=expand, kernel=(3, 3), activation="relu"), f"{name}_sq")
            g.add_vertex(name, MergeVertex(), f"{name}_e1", f"{name}_e3")
            return name

        g.add_layer("c1", ConvolutionLayer(n_out=64, kernel=(3, 3),
                                           stride=(2, 2), padding="valid",
                                           activation="relu"), "in")
        g.add_layer("p1", SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), "c1")
        x = fire("f2", "p1", 16, 64)
        x = fire("f3", x, 16, 64)
        g.add_layer("p3", SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), x)
        x = fire("f4", "p3", 32, 128)
        x = fire("f5", x, 32, 128)
        g.add_layer("p5", SubsamplingLayer(kernel=(3, 3), stride=(2, 2)), x)
        x = fire("f6", "p5", 48, 192)
        x = fire("f7", x, 48, 192)
        x = fire("f8", x, 64, 256)
        x = fire("f9", x, 64, 256)
        g.add_layer("drop", DropoutLayer(dropout=0.5), x)
        g.add_layer("c10", ConvolutionLayer(n_out=self.num_classes,
                                            kernel=(1, 1), activation="relu"),
                    "drop")
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), "c10")
        g.add_layer("out", LossLayer(loss="mcxent", activation="softmax"),
                    "avgpool")
        g.set_outputs("out")
        return self._graph(g.build())


class UNet(_NotPorted):
    """Needs ``Deconvolution2D`` (``nn/layers/convolutional.py``)."""

    name = "unet"
    input_shape = (512, 512, 3)

    def __init__(self, num_classes: int = 1, **kw):
        super().__init__(num_classes=num_classes, **kw)


class Xception(_NotPorted):
    """Needs ``SeparableConvolution2D`` (``nn/layers/convolutional.py``)."""

    name = "xception"
    input_shape = (299, 299, 3)


class NASNet(_NotPorted):
    """Needs ``SeparableConvolution2D`` and ``Cropping2D``
    (``nn/layers/convolutional.py``)."""

    name = "nasnet"
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000,
                 penultimate_filters: int = 1056, n_cells: int = 4, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.penultimate_filters = int(penultimate_filters)
        self.n_cells = int(n_cells)
