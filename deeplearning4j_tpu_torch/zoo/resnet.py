"""ResNet-50 (counterpart of ``deeplearning4j_tpu/zoo/resnet.py``): the
stem and [3, 4, 6, 3] bottleneck stages over a ComputationGraph, NHWC,
at the JAX package's widths; BASELINE.md's config 2."""
from __future__ import annotations

from ..nn import NeuralNetConfiguration
from ..nn.conf import InputType
from ..nn.graph import ElementWiseVertex
from ..nn.layers import (ActivationLayer, BatchNormalization, ConvolutionLayer,
                         GlobalPoolingLayer, OutputLayer, SubsamplingLayer,
                         ZeroPaddingLayer)
from . import ZooModel


class ResNet50(ZooModel):
    """ResNet-50 v1: stem + [3, 4, 6, 3] bottleneck stages."""

    name = "resnet50"
    input_shape = (224, 224, 3)

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
            g.add_layer(f"{name}_conv", ConvolutionLayer(
                n_out=n_out, kernel=kernel, stride=stride, padding=padding,
                has_bias=False, activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation=act), f"{name}_conv")
            return name

        def bottleneck(name, inp, filters, stride, downsample):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, f1, (1, 1), stride)
            x = conv_bn(f"{name}_b", x, f2, (3, 3))
            x = conv_bn(f"{name}_c", x, f3, (1, 1), act="identity")
            if downsample:
                sc = conv_bn(f"{name}_sc", inp, f3, (1, 1), stride,
                             act="identity")
            else:
                sc = inp
            g.add_vertex(f"{name}_add", ElementWiseVertex("add"), x, sc)
            g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        # stem: 7x7/2 conv + BN + 3x3/2 maxpool
        x = conv_bn("stem", "in", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                                  padding="same"), x)
        x = "stem_pool"
        stages = ((64, 64, 256, 3), (128, 128, 512, 4),
                  (256, 256, 1024, 6), (512, 512, 2048, 3))
        for si, (f1, f2, f3, reps) in enumerate(stages):
            for r in range(reps):
                stride = (1, 1) if (si == 0 or r > 0) else (2, 2)
                x = bottleneck(f"s{si}b{r}", x, (f1, f2, f3), stride,
                               downsample=(r == 0))
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("out", OutputLayer(n_out=self.num_classes, loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        return self._graph(g.build())
