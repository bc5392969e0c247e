"""Transfer learning with the PyTorch/CUDA port: train a base net,
freeze its features, retrain a new head (the port's counterpart of
``examples/transfer_learning.py``), on an NVIDIA GPU, or on the CPU
with ``--cpu``.

    python examples/torch/transfer_learning.py [--cpu] [--quick]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, TransferLearning)


def main(quick: bool = False, device=None):
    rs = np.random.RandomState(0)
    x = rs.rand(512, 10).astype(np.float32)
    # base task: 4 classes by quadrant of two feature sums
    q = ((x[:, :5].sum(1) > 2.5).astype(int) * 2
         + (x[:, 5:].sum(1) > 2.5).astype(int))
    y4 = np.eye(4, dtype=np.float32)[q]

    base_conf = (NeuralNetConfiguration.builder().seed(1)
                 .updater(Adam(1e-2)).weight_init("xavier").list()
                 .layer(DenseLayer(n_out=64, activation="relu"))
                 .layer(DenseLayer(n_out=32, activation="relu"))
                 .layer(OutputLayer(n_out=4, loss="mcxent",
                                    activation="softmax"))
                 .input_type_feed_forward(10).build())
    base = MultiLayerNetwork(base_conf, device=device).init()
    base.fit(x, y4, epochs=40 if quick else 80)

    # a new binary task on the learned features
    y2 = np.eye(2, dtype=np.float32)[(q >= 2).astype(int)]
    net = (TransferLearning.builder(base)
           .fine_tune_configuration(
               FineTuneConfiguration.builder().updater(Adam(1e-2)).seed(2)
               .build())
           .set_feature_extractor(1)          # freeze layers 0..1
           .remove_output_layer()
           .add_layer(OutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
           .build())
    net.fit(x, y2, epochs=40 if quick else 60)
    acc = net.evaluate([(x, y2)]).accuracy()
    print(f"transferred-head accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main(quick="--quick" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else None)
