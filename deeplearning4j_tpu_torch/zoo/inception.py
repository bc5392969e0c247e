"""Inception-family zoo models (counterpart of
``deeplearning4j_tpu/zoo/inception.py``): InceptionResNetV1 and
FaceNetNN4Small2, face-recognition graphs with an L2-normalized
embedding head, at the JAX package's widths."""
from __future__ import annotations

from ..nn import NeuralNetConfiguration
from ..nn.conf import InputType
from ..nn.graph import (ElementWiseVertex, L2NormalizeVertex, MergeVertex,
                        ScaleVertex)
from ..nn.layers import (ActivationLayer, BatchNormalization, ConvolutionLayer,
                         DenseLayer, GlobalPoolingLayer, OutputLayer,
                         SubsamplingLayer)
from . import ZooModel


class InceptionResNetV1(ZooModel):
    """Inception-ResNet-v1: the stem, 5 A blocks, reduction A, 10 B
    blocks, reduction B and 5 C blocks, each residual branch scaled
    before the add."""

    name = "inceptionresnetv1"
    input_shape = (160, 160, 3)

    def __init__(self, num_classes: int = 1001, embedding: int = 128, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.embedding = int(embedding)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, kernel, stride=(1, 1), padding="same",
                    act="relu"):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel=kernel, stride=stride, padding=padding,
                has_bias=False, activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation=act), f"{name}_c")
            return name

        def block_a(name, inp, scale=0.17):
            b0 = conv_bn(f"{name}_b0", inp, 32, (1, 1))
            b1 = conv_bn(f"{name}_b1a", inp, 32, (1, 1))
            b1 = conv_bn(f"{name}_b1b", b1, 32, (3, 3))
            b2 = conv_bn(f"{name}_b2a", inp, 32, (1, 1))
            b2 = conv_bn(f"{name}_b2b", b2, 32, (3, 3))
            b2 = conv_bn(f"{name}_b2c", b2, 32, (3, 3))
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1, b2)
            up = conv_bn(f"{name}_up", f"{name}_cat", 256, (1, 1),
                         act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex("add"), inp,
                         f"{name}_scale")
            g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
            return name

        def block_b(name, inp, scale=0.10):
            b0 = conv_bn(f"{name}_b0", inp, 128, (1, 1))
            b1 = conv_bn(f"{name}_b1a", inp, 128, (1, 1))
            b1 = conv_bn(f"{name}_b1b", b1, 128, (1, 7))
            b1 = conv_bn(f"{name}_b1c", b1, 128, (7, 1))
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
            up = conv_bn(f"{name}_up", f"{name}_cat", 896, (1, 1),
                         act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex("add"), inp,
                         f"{name}_scale")
            g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
            return name

        def block_c(name, inp, scale=0.20):
            b0 = conv_bn(f"{name}_b0", inp, 192, (1, 1))
            b1 = conv_bn(f"{name}_b1a", inp, 192, (1, 1))
            b1 = conv_bn(f"{name}_b1b", b1, 192, (1, 3))
            b1 = conv_bn(f"{name}_b1c", b1, 192, (3, 1))
            g.add_vertex(f"{name}_cat", MergeVertex(), b0, b1)
            up = conv_bn(f"{name}_up", f"{name}_cat", 1792, (1, 1),
                         act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex("add"), inp,
                         f"{name}_scale")
            g.add_layer(name, ActivationLayer(activation="relu"), f"{name}_add")
            return name

        # stem
        x = conv_bn("stem1", "in", 32, (3, 3), (2, 2))
        x = conv_bn("stem2", x, 32, (3, 3))
        x = conv_bn("stem3", x, 64, (3, 3))
        g.add_layer("stem_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                                  padding="same"), x)
        x = conv_bn("stem4", "stem_pool", 80, (1, 1))
        x = conv_bn("stem5", x, 192, (3, 3))
        x = conv_bn("stem6", x, 256, (3, 3), (2, 2))
        for i in range(5):
            x = block_a(f"a{i}", x)
        # reduction A
        r0 = conv_bn("redA_b0", x, 384, (3, 3), (2, 2))
        r1 = conv_bn("redA_b1a", x, 192, (1, 1))
        r1 = conv_bn("redA_b1b", r1, 192, (3, 3))
        r1 = conv_bn("redA_b1c", r1, 256, (3, 3), (2, 2))
        g.add_layer("redA_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                                  padding="same"), x)
        g.add_vertex("redA", MergeVertex(), r0, r1, "redA_pool")
        x = "redA"
        for i in range(10):
            x = block_b(f"b{i}", x)
        # reduction B
        r0 = conv_bn("redB_b0a", x, 256, (1, 1))
        r0 = conv_bn("redB_b0b", r0, 384, (3, 3), (2, 2))
        r1 = conv_bn("redB_b1a", x, 256, (1, 1))
        r1 = conv_bn("redB_b1b", r1, 256, (3, 3), (2, 2))
        r2 = conv_bn("redB_b2a", x, 256, (1, 1))
        r2 = conv_bn("redB_b2b", r2, 256, (3, 3))
        r2 = conv_bn("redB_b2c", r2, 256, (3, 3), (2, 2))
        g.add_layer("redB_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                                  padding="same"), x)
        g.add_vertex("redB", MergeVertex(), r0, r1, r2, "redB_pool")
        x = "redB"
        for i in range(5):
            x = block_c(f"c{i}", x)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding,
                                             activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", OutputLayer(n_out=self.num_classes, loss="mcxent"),
                    "embeddings")
        g.set_outputs("out")
        return self._graph(g.build())


class FaceNetNN4Small2(ZooModel):
    """The NN4.small2 inception variant for face embeddings."""

    name = "facenetnn4small2"
    input_shape = (96, 96, 3)

    def __init__(self, num_classes: int = 1000, embedding: int = 128, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.embedding = int(embedding)

    def init(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self._updater()).weight_init("relu")
             .graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))

        def conv_bn(name, inp, n_out, kernel, stride=(1, 1)):
            g.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel=kernel, stride=stride, padding="same",
                has_bias=False, activation="identity"), inp)
            g.add_layer(name, BatchNormalization(activation="relu"), f"{name}_c")
            return name

        def inception(name, inp, c1, c3r, c3, c5r, c5, pool_proj,
                      stride=(1, 1)):
            branches = []
            if c1:
                branches.append(conv_bn(f"{name}_1x1", inp, c1, (1, 1), stride))
            b3 = conv_bn(f"{name}_3r", inp, c3r, (1, 1))
            branches.append(conv_bn(f"{name}_3", b3, c3, (3, 3), stride))
            if c5:
                b5 = conv_bn(f"{name}_5r", inp, c5r, (1, 1))
                branches.append(conv_bn(f"{name}_5", b5, c5, (5, 5), stride))
            g.add_layer(f"{name}_pool", SubsamplingLayer(
                kernel=(3, 3), stride=stride, padding="same"), inp)
            if pool_proj:
                branches.append(conv_bn(f"{name}_pp", f"{name}_pool",
                                        pool_proj, (1, 1)))
            else:
                branches.append(f"{name}_pool")
            g.add_vertex(name, MergeVertex(), *branches)
            return name

        x = conv_bn("c1", "in", 64, (7, 7), (2, 2))
        g.add_layer("p1", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           padding="same"), x)
        x = conv_bn("c2", "p1", 64, (1, 1))
        x = conv_bn("c3", x, 192, (3, 3))
        g.add_layer("p2", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           padding="same"), x)
        x = inception("i3a", "p2", 64, 96, 128, 16, 32, 32)
        x = inception("i3b", x, 64, 96, 128, 32, 64, 64)
        x = inception("i3c", x, 0, 128, 256, 32, 64, 0, stride=(2, 2))
        x = inception("i4a", x, 256, 96, 192, 32, 64, 128)
        x = inception("i4e", x, 0, 160, 256, 64, 128, 0, stride=(2, 2))
        x = inception("i5a", x, 256, 96, 384, 0, 0, 96)
        x = inception("i5b", x, 256, 96, 384, 0, 0, 96)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding,
                                             activation="identity"), "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", OutputLayer(n_out=self.num_classes, loss="mcxent"),
                    "embeddings")
        g.set_outputs("out")
        return self._graph(g.build())
