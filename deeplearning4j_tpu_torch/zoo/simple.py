"""Sequential zoo models (counterpart of
``deeplearning4j_tpu/zoo/simple.py``): LeNet, SimpleCNN, AlexNet, VGG16,
VGG19 and Darknet19, NHWC, and the character-level TextGenerationLSTM,
at the JAX package's widths. TinyYOLO and YOLO2 need
``Yolo2OutputLayer`` and raise until it is ported."""
from __future__ import annotations

from ..learning import Nesterovs
from ..nn import NeuralNetConfiguration
from ..nn.layers import (BatchNormalization, ConvolutionLayer, DenseLayer,
                         DropoutLayer, GlobalPoolingLayer,
                         LocalResponseNormalization, LossLayer, OutputLayer,
                         SubsamplingLayer)
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


class _NotPorted(ZooModel):
    def init(self):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet (ROADMAP.md queue A, "
            f"item 13)")


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


class TinyYOLO(_NotPorted):
    """Needs ``Yolo2OutputLayer`` (``nn/layers/objdetect.py``)."""

    name = "tinyyolo"
    input_shape = (416, 416, 3)


class YOLO2(_NotPorted):
    """Needs ``Yolo2OutputLayer`` (``nn/layers/objdetect.py``)."""

    name = "yolo2"
    input_shape = (608, 608, 3)


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
