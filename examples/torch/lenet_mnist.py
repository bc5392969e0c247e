"""LeNet on MNIST (BASELINE config 1) with the PyTorch/CUDA port, on an
NVIDIA GPU, or on the CPU with ``--cpu``. Without MNIST's IDX files it
trains on the vendored real handwritten digits.

    python examples/torch/lenet_mnist.py [--cpu] [--quick]

(It sits in a folder of its own: ``tests/test_examples.py`` runs every
script directly under ``examples/``, the JAX package's examples.)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.optimize import ScoreIterationListener


def main(quick: bool = False, device=None):
    conf = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
            .weight_init("relu").list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent",
                               activation="softmax"))
            .input_type_convolutional(28, 28, 1).build())
    net = MultiLayerNetwork(conf, device=device).init()
    net.set_listeners(ScoreIterationListener(50))

    n = 1024 if quick else None
    train = MnistDataSetIterator(batch=128, train=True, flatten=False,
                                 num_examples=n)
    test = MnistDataSetIterator(batch=512, train=False, flatten=False,
                                num_examples=n)
    net.fit(train, epochs=1 if quick else 12)
    ev = net.evaluate(test)
    print(ev.stats())
    print(f"data: {train.source}")
    return ev.accuracy()


if __name__ == "__main__":
    main(quick="--quick" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
