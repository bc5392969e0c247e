"""Sequential zoo models (counterpart of
``deeplearning4j_tpu/zoo/simple.py``): LeNet, SimpleCNN, AlexNet, VGG16,
VGG19, Darknet19 and TinyYOLO, NHWC, the character-level
TextGenerationLSTM, and YOLO2 (a ComputationGraph for its passthrough),
at the JAX package's widths."""
from __future__ import annotations

from ..learning import Nesterovs
from ..nn import NeuralNetConfiguration
from ..nn.layers import (BatchNormalization, ConvolutionLayer, DenseLayer,
                         DropoutLayer, GlobalPoolingLayer,
                         LocalResponseNormalization, LossLayer, OutputLayer,
                         SubsamplingLayer)
from ..nn.conf import InputType
from ..nn.graph import MergeVertex
from ..nn.layers.convolutional import SpaceToDepthLayer
from ..nn.layers.objdetect import Yolo2OutputLayer
from ..nn.layers.recurrent import LSTM, RnnOutputLayer
from . import ZooModel


class LeNet(ZooModel):
    """28x28x1: conv5-20 / maxpool / conv5-50 / maxpool / dense500 /
    softmax."""

    name = "lenet"
    input_shape = (28, 28, 1)

    def __init__(self, num_classes: int = 10, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(self._updater()).weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1),
                                        padding="same", activation="identity"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1),
                                        padding="same", activation="identity"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
                .input_type_convolutional(h, w, c).build())
        return self._net(conf)


class SimpleCNN(ZooModel):
    """48x48x3: six 3x3 conv layers (relu) each followed by batch
    norm, a 2x2 max pool after every second, dropout 0.5, dense256,
    softmax."""

    name = "simplecnn"
    input_shape = (48, 48, 3)

    def __init__(self, num_classes: int = 10, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .activation("relu")
             .list())
        for n_out, pool in ((16, False), (16, True), (32, False), (32, True),
                            (64, False), (64, True)):
            b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3)))
            b.layer(BatchNormalization())
            if pool:
                b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        b.layer(DropoutLayer(dropout=0.5))
        b.layer(DenseLayer(n_out=256, activation="relu"))
        b.layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
        return self._net(b.input_type_convolutional(h, w, c).build())


class AlexNet(ZooModel):
    """One-tower AlexNet with local response normalization, 224x224x3."""

    name = "alexnet"
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        lrn = dict(k=2, n=5, alpha=1e-4, beta=0.75)
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(self.updater or Nesterovs(1e-2, 0.9))
                .weight_init("normal").activation("relu")
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel=(11, 11),
                                        stride=(4, 4), padding="valid"))
                .layer(LocalResponseNormalization(**lrn))
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel=(5, 5),
                                        padding="same", bias_init=1.0))
                .layer(LocalResponseNormalization(**lrn))
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3)))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3),
                                        bias_init=1.0))
                .layer(ConvolutionLayer(n_out=256, kernel=(3, 3),
                                        bias_init=1.0))
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, dropout=0.5, bias_init=1.0))
                .layer(DenseLayer(n_out=4096, dropout=0.5, bias_init=1.0))
                .layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
                .input_type_convolutional(h, w, c).build())
        return self._net(conf)


class VGG16(ZooModel):
    """VGG16, 224x224x3."""

    name = "vgg16"
    input_shape = (224, 224, 3)
    _spec = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

    def __init__(self, num_classes: int = 1000, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Nesterovs(1e-2, 0.9))
             .weight_init("relu").list())
        for n_convs, n_out in self._spec:
            for _ in range(n_convs):
                b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                         activation="relu"))
            b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, loss="mcxent"))
        return self._net(b.input_type_convolutional(h, w, c).build())


class VGG19(VGG16):
    name = "vgg19"
    _spec = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


def _dark_conv(b, n_out, kernel=(3, 3)):
    b.layer(ConvolutionLayer(n_out=n_out, kernel=kernel, padding="same",
                             has_bias=False, activation="identity"))
    b.layer(BatchNormalization(activation="leakyrelu"))


class Darknet19(ZooModel):
    """Darknet-19: 3x3 and 1x1 convolutions (32 to 1024 channels), each
    without bias and followed by batch norm and a leaky ReLU, five 2x2
    max pools, then a 1x1 class conv, global average pooling and a
    softmax loss; 224x224x3 in by default."""

    name = "darknet19"
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu").list())
        for stage in ((32,), (64,), (128, 64, 128), (256, 128, 256),
                      (512, 256, 512, 256, 512), (1024, 512, 1024, 512, 1024)):
            if stage[0] > 32:
                b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            for i, n_out in enumerate(stage):
                _dark_conv(b, n_out, (3, 3) if i % 2 == 0 else (1, 1))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel=(1, 1),
                                 activation="identity"))
        b.layer(GlobalPoolingLayer(pooling="avg"))
        b.layer(LossLayer(loss="mcxent", activation="softmax"))
        return self._net(b.input_type_convolutional(h, w, c).build())


class TinyYOLO(ZooModel):
    """The tiny Darknet backbone (six 3x3 convolutions without bias,
    each with batch norm and a leaky ReLU, 2x2 max pools, a stride-1
    "same" pool after the 512 conv) and a YOLOv2 head over 5 anchors:
    416x416x3 in, a 13x13 grid out."""

    name = "tinyyolo"
    input_shape = (416, 416, 3)
    anchors = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
               (16.62, 10.52))

    def __init__(self, num_classes: int = 20, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu").list())
        for n_out in (16, 32, 64, 128, 256):
            _dark_conv(b, n_out)
            b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
        _dark_conv(b, 512)
        b.layer(SubsamplingLayer(kernel=(2, 2), stride=(1, 1),
                                 padding="same"))
        _dark_conv(b, 1024)
        _dark_conv(b, 1024)
        A = len(self.anchors)
        b.layer(ConvolutionLayer(n_out=A * (5 + self.num_classes),
                                 kernel=(1, 1), activation="identity"))
        b.layer(Yolo2OutputLayer(anchors=self.anchors))
        return self._net(b.input_type_convolutional(h, w, c).build())


class YOLO2(ZooModel):
    """YOLOv2: the Darknet19 backbone as a ComputationGraph, its 26x26
    route (``c5e``) through ``SpaceToDepthLayer(2)`` merged with the
    13x13 ``c7b``, a 3x3 conv and the YOLOv2 head over 5 anchors:
    608x608x3 in, a 19x19 grid out."""

    name = "yolo2"
    input_shape = (608, 608, 3)
    anchors = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
               (7.88282, 3.52778), (9.77052, 9.16828))

    def __init__(self, num_classes: int = 80, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, kernel=(3, 3)):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel=kernel, padding="same", has_bias=False,
                activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation="leakyrelu"),
                        f"{name}_c")
            return name

        def pool(name, inp):
            g.add_layer(name, SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                        inp)
            return name

        x = pool("p1", conv_bn("c1", "in", 32))
        x = pool("p2", conv_bn("c2", x, 64))
        x = conv_bn("c3a", x, 128)
        x = conv_bn("c3b", x, 64, (1, 1))
        x = pool("p3", conv_bn("c3c", x, 128))
        x = conv_bn("c4a", x, 256)
        x = conv_bn("c4b", x, 128, (1, 1))
        x = pool("p4", conv_bn("c4c", x, 256))
        x = conv_bn("c5a", x, 512)
        x = conv_bn("c5b", x, 256, (1, 1))
        x = conv_bn("c5c", x, 512)
        x = conv_bn("c5d", x, 256, (1, 1))
        passthrough = conv_bn("c5e", x, 512)      # the route's source
        x = pool("p5", passthrough)
        x = conv_bn("c6a", x, 1024)
        x = conv_bn("c6b", x, 512, (1, 1))
        x = conv_bn("c6c", x, 1024)
        x = conv_bn("c6d", x, 512, (1, 1))
        x = conv_bn("c6e", x, 1024)
        x = conv_bn("c7a", x, 1024)
        x = conv_bn("c7b", x, 1024)
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2), passthrough)
        g.add_vertex("route", MergeVertex(), "reorg", x)
        x = conv_bn("c8", "route", 1024)
        A = len(self.anchors)
        g.add_layer("pred", ConvolutionLayer(
            n_out=A * (5 + self.num_classes), kernel=(1, 1),
            activation="identity"), x)
        g.add_layer("yolo", Yolo2OutputLayer(anchors=self.anchors), "pred")
        g.set_outputs("yolo")
        return self._graph(g.build())


class TextGenerationLSTM(ZooModel):
    """Character-level 2 x LSTM(256) with a per-timestep softmax over
    ``num_classes`` characters (77) and 40 timesteps, as DL4J's
    character-modelling example builds it."""

    name = "textgenlstm"

    def __init__(self, num_classes: int = 77, timesteps: int = 40,
                 hidden: int = 256, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.timesteps = int(timesteps)
        self.hidden = int(hidden)

    def init(self):
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(self._updater()).weight_init("xavier")
                .list()
                .layer(LSTM(n_out=self.hidden, activation="tanh"))
                .layer(LSTM(n_out=self.hidden, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.num_classes, loss="mcxent"))
                .input_type_recurrent(self.num_classes, self.timesteps)
                .build())
        return self._net(conf)
