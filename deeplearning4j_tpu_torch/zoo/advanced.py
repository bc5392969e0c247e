"""SqueezeNet, UNet, Xception and NASNet (counterpart of
``deeplearning4j_tpu/zoo/advanced.py``): graphs at the JAX package's
widths, node for node as JAX builds them, so a graph from a seed holds
JAX's params. UNet upsamples with ``Deconvolution2D``, Xception and
NASNet stack ``SeparableConvolution2D`` (``nn/layers/convolutional.py``)."""
from __future__ import annotations

from ..nn import NeuralNetConfiguration
from ..nn.conf import InputType
from ..nn.graph import ElementWiseVertex, MergeVertex
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         ConvolutionLayer, DropoutLayer, GlobalPoolingLayer,
                         LossLayer, OutputLayer, SubsamplingLayer)
from ..nn.layers.convolutional import Deconvolution2D, SeparableConvolution2D
from . import ZooModel


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


class UNet(ZooModel):
    """U-Net: four encoder stages of two 3x3 convolutions and a 2x2 max
    pool (64 to 512 channels, dropout 0.5 on the deepest), a 1024-channel
    middle, four decoder stages of a 2x2 stride-2 ``Deconvolution2D``
    merged with the encoder's skip, a 2-channel 3x3 and a 1x1 sigmoid
    class conv under ``xent``: a [H, W, num_classes] mask, 512x512x3 in
    by default."""

    name = "unet"
    input_shape = (512, 512, 3)

    def __init__(self, num_classes: int = 1, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def double_conv(name, inp, n_out):
            g.add_layer(f"{name}_1", ConvolutionLayer(
                n_out=n_out, kernel=(3, 3), activation="relu"), inp)
            g.add_layer(f"{name}_2", ConvolutionLayer(
                n_out=n_out, kernel=(3, 3), activation="relu"), f"{name}_1")
            return f"{name}_2"

        enc1 = double_conv("e1", "in", 64)
        g.add_layer("p1", SubsamplingLayer(kernel=(2, 2), stride=(2, 2)), enc1)
        enc2 = double_conv("e2", "p1", 128)
        g.add_layer("p2", SubsamplingLayer(kernel=(2, 2), stride=(2, 2)), enc2)
        enc3 = double_conv("e3", "p2", 256)
        g.add_layer("p3", SubsamplingLayer(kernel=(2, 2), stride=(2, 2)), enc3)
        enc4 = double_conv("e4", "p3", 512)
        g.add_layer("drop4", DropoutLayer(dropout=0.5), enc4)
        g.add_layer("p4", SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                    "drop4")
        mid = double_conv("mid", "p4", 1024)
        g.add_layer("dropmid", DropoutLayer(dropout=0.5), mid)

        def up_block(name, inp, skip, n_out):
            g.add_layer(f"{name}_up", Deconvolution2D(
                n_out=n_out, kernel=(2, 2), stride=(2, 2),
                activation="relu"), inp)
            g.add_vertex(f"{name}_cat", MergeVertex(), skip, f"{name}_up")
            return double_conv(name, f"{name}_cat", n_out)

        d4 = up_block("d4", "dropmid", "drop4", 512)
        d3 = up_block("d3", d4, enc3, 256)
        d2 = up_block("d2", d3, enc2, 128)
        d1 = up_block("d1", d2, enc1, 64)
        g.add_layer("penult", ConvolutionLayer(n_out=2, kernel=(3, 3),
                                               activation="relu"), d1)
        g.add_layer("pred", ConvolutionLayer(n_out=self.num_classes,
                                             kernel=(1, 1),
                                             activation="sigmoid"), "penult")
        g.add_layer("out", LossLayer(loss="xent", activation="identity"),
                    "pred")
        g.set_outputs("out")
        return self._graph(g.build())


class Xception(ZooModel):
    """Xception: an entry flow of two convolutions and three residual
    blocks of separable convolutions (128, 256, 728 channels, each
    halving the size with a 3x3 max pool beside a strided 1x1
    shortcut), a middle flow of eight residual blocks of three 728-wide
    separable convolutions, and an exit flow to 2048 channels; batch
    norm after every convolution, 299x299x3 in by default."""

    name = "xception"
    input_shape = (299, 299, 3)

    def __init__(self, num_classes: int = 1000, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, kernel, stride=(1, 1), act="relu",
                    padding="same"):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel=kernel, stride=stride, padding=padding,
                has_bias=False, activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation=act), f"{name}_c")
            return name

        def sep_bn(name, inp, n_out, act="relu"):
            g.add_layer(f"{name}_s", SeparableConvolution2D(
                n_out=n_out, kernel=(3, 3), has_bias=False,
                activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation=act), f"{name}_s")
            return name

        x = conv_bn("b1c1", "in", 32, (3, 3), (2, 2), padding="valid")
        x = conv_bn("b1c2", x, 64, (3, 3), padding="valid")

        def xception_block(name, inp, n_out, first_act=True):
            sc = conv_bn(f"{name}_sc", inp, n_out, (1, 1), (2, 2),
                         act="identity")
            y = inp
            if first_act:
                g.add_layer(f"{name}_preact", ActivationLayer(
                    activation="relu"), y)
                y = f"{name}_preact"
            y = sep_bn(f"{name}_s1", y, n_out)
            y = sep_bn(f"{name}_s2", y, n_out, act="identity")
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel=(3, 3), stride=(2, 2), padding="same"), y)
            g.add_vertex(name, ElementWiseVertex("add"), f"{name}_pool", sc)
            return name

        x = xception_block("b2", x, 128, first_act=False)
        x = xception_block("b3", x, 256)
        x = xception_block("b4", x, 728)
        for i in range(8):          # the middle flow
            name = f"m{i}"
            g.add_layer(f"{name}_a1", ActivationLayer(activation="relu"), x)
            y = sep_bn(f"{name}_s1", f"{name}_a1", 728)
            y = sep_bn(f"{name}_s2", y, 728)
            y = sep_bn(f"{name}_s3", y, 728, act="identity")
            g.add_vertex(name, ElementWiseVertex("add"), y, x)
            x = name
        sc = conv_bn("exit_sc", x, 1024, (1, 1), (2, 2), act="identity")
        g.add_layer("exit_a", ActivationLayer(activation="relu"), x)
        y = sep_bn("exit_s1", "exit_a", 728)
        y = sep_bn("exit_s2", y, 1024, act="identity")
        g.add_layer("exit_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                                  padding="same"), y)
        g.add_vertex("exit_add", ElementWiseVertex("add"), "exit_pool", sc)
        y = sep_bn("exit_s3", "exit_add", 1536)
        y = sep_bn("exit_s4", y, 2048)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), y)
        g.add_layer("out", OutputLayer(n_out=self.num_classes, loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        return self._graph(g.build())


class NASNet(ZooModel):
    """NASNet-A mobile: a strided 3x3 stem, two reduction cells, then
    three stacks of ``n_cells`` normal cells with a reduction cell
    between them, every cell built from separable-convolution blocks,
    1x1 channel adjusts and pools; ``penultimate_filters // 24``
    channels a cell at the first stack, 224x224x3 in by default."""

    name = "nasnet"
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000,
                 penultimate_filters: int = 1056, n_cells: int = 4, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.penultimate_filters = int(penultimate_filters)
        self.n_cells = int(n_cells)

    def init(self):
        h, w, c = self.input_shape
        filters = self.penultimate_filters // 24
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def sep_block(name, inp, n_out, kernel=(3, 3), stride=(1, 1)):
            g.add_layer(f"{name}_a", ActivationLayer(activation="relu"), inp)
            g.add_layer(f"{name}_s1", SeparableConvolution2D(
                n_out=n_out, kernel=kernel, stride=stride, has_bias=False,
                activation="identity"), f"{name}_a")
            g.add_layer(f"{name}_b1", BatchNormalization(activation="relu"),
                        f"{name}_s1")
            g.add_layer(f"{name}_s2", SeparableConvolution2D(
                n_out=n_out, kernel=kernel, has_bias=False,
                activation="identity"), f"{name}_b1")
            g.add_layer(name, BatchNormalization(activation="identity"),
                        f"{name}_s2")
            return name

        def fit_channels(name, inp, n_out, stride=(1, 1)):
            """A 1x1 convolution that aligns the channels."""
            g.add_layer(f"{name}_a", ActivationLayer(activation="relu"), inp)
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel=(1, 1), stride=stride, has_bias=False,
                activation="identity"), f"{name}_a")
            g.add_layer(name, BatchNormalization(activation="identity"),
                        f"{name}_c")
            return name

        def normal_cell(name, x, prev, f, adjust_stride=(1, 1)):
            # adjust_stride (2, 2) where prev comes from before a
            # reduction cell
            p = fit_channels(f"{name}_adj", prev, f, stride=adjust_stride)
            hx = fit_channels(f"{name}_h", x, f)
            b1 = sep_block(f"{name}_b1", hx, f, (5, 5))
            g.add_vertex(f"{name}_a1", ElementWiseVertex("add"), b1, hx)
            b2 = sep_block(f"{name}_b2a", p, f, (5, 5))
            b2b = sep_block(f"{name}_b2b", hx, f, (3, 3))
            g.add_vertex(f"{name}_a2", ElementWiseVertex("add"), b2, b2b)
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel=(3, 3), stride=(1, 1), padding="same", pooling="avg"),
                hx)
            g.add_vertex(f"{name}_a3", ElementWiseVertex("add"),
                         f"{name}_pool", p)
            g.add_vertex(name, MergeVertex(), f"{name}_a1", f"{name}_a2",
                         f"{name}_a3")
            return name, x

        def reduction_cell(name, x, prev, f, adjust_stride=(1, 1)):
            p = fit_channels(f"{name}_adj", prev, f,
                             stride=tuple(2 * s for s in adjust_stride))
            hx = fit_channels(f"{name}_h", x, f)
            b1 = sep_block(f"{name}_b1", hx, f, (5, 5), (2, 2))
            b2 = sep_block(f"{name}_b2", hx, f, (7, 7), (2, 2))
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel=(3, 3), stride=(2, 2), padding="same"), hx)
            g.add_vertex(f"{name}_a1", ElementWiseVertex("add"), b1, b2)
            g.add_vertex(f"{name}_a2", ElementWiseVertex("add"),
                         f"{name}_pool", p)
            g.add_vertex(name, MergeVertex(), f"{name}_a1", f"{name}_a2")
            return name, x

        g.add_layer("stem_c", ConvolutionLayer(
            n_out=32, kernel=(3, 3), stride=(2, 2), has_bias=False,
            padding="valid", activation="identity"), "in")
        g.add_layer("stem", BatchNormalization(activation="identity"),
                    "stem_c")
        # `prev` lags `x` by one cell; after a reduction the lagging
        # tensor is twice the size, so the next cell adjusts it with
        # stride 2
        x, prev = "stem", "stem"
        x, prev = reduction_cell("stem_r1", x, prev, filters // 4)
        x, prev = reduction_cell("stem_r2", x, prev, filters // 2,
                                 adjust_stride=(2, 2))
        for stack, width in enumerate((filters, filters * 2, filters * 4)):
            if stack:
                x, prev = reduction_cell(f"r{stack}", x, prev, width)
            for i in range(self.n_cells):
                x, prev = normal_cell(
                    f"n{stack + 1}_{i}", x, prev, width,
                    adjust_stride=(2, 2) if i == 0 else (1, 1))
        g.add_layer("final_act", ActivationLayer(activation="relu"), x)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), "final_act")
        g.add_layer("out", OutputLayer(n_out=self.num_classes, loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        return self._graph(g.build())
