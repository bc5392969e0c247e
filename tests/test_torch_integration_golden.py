"""The integration golden cases on the port.

``tests/integration_cases.py`` builds seven seeded cases of 5 steps
each, and ``tests/fixtures/integration/*.npz`` commits the JAX
package's params, predictions and losses after them
(``tests/test_integration_golden.py`` holds the JAX package there).
Here the same cases are built with the port's classes on the CPU and
held to the same files at the golden runner's tolerances: losses rtol
1e-5 / atol 1e-6, predictions and params rtol 1e-4 / atol 1e-5.
``autoencoder`` is held in ``tests/test_torch_pretrain_layers.py``;
this file holds the other six. The batches and probes are the golden
runner's own (``integration_cases._batches``, numpy only).
"""
import os

import numpy as np
import pytest
import torch

from integration_cases import N_STEPS, _batches

from deeplearning4j_tpu_torch.learning import Adam, Sgd
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (BatchNormalization,
                                                ConvolutionLayer,
                                                DenseLayer, OutputLayer,
                                                SubsamplingLayer,
                                                Upsampling2D)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                          RnnOutputLayer)

BASE = os.path.join(os.path.dirname(__file__), "fixtures", "integration")


def case_mlp():
    conf = (NeuralNetConfiguration.builder().seed(42).updater(Adam(1e-3))
            .weight_init("xavier").l2(1e-4).list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.0))
            .layer(OutputLayer(n_out=4, loss="mcxent", activation="softmax"))
            .input_type_feed_forward(10).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    return model, _batches((16, 10), 4, seed=1), \
        np.random.RandomState(99).rand(8, 10).astype(np.float32)


def case_cnn2d():
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.05))
            .weight_init("relu").list()
            .layer(ConvolutionLayer(n_out=8, kernel=(3, 3),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(BatchNormalization())
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .input_type_convolutional(12, 12, 1).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    return model, _batches((8, 12, 12, 1), 3, seed=2), \
        np.random.RandomState(98).rand(4, 12, 12, 1).astype(np.float32)


def case_rnn():
    conf = (NeuralNetConfiguration.builder().seed(11).updater(Adam(5e-3))
            .weight_init("xavier").list()
            .layer(LSTM(n_out=12, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .input_type_recurrent(6).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    return model, _batches((4, 7, 6), 3, seed=3, seq=True), \
        np.random.RandomState(97).rand(2, 7, 6).astype(np.float32)


def case_transfer():
    """Train a base MLP, freeze the feature layer, swap the head, train
    the head (ref: TransferLearningTestCases.java)."""
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    base, batches, probe = case_mlp()
    for x, y in batches:
        base.fit(x, y)
    net = (TransferLearning.builder(base)
           .fine_tune_configuration(
               FineTuneConfiguration.builder().updater(Sgd(0.05)).seed(5)
               .build())
           .set_feature_extractor(1)
           .remove_output_layer()
           .add_layer(OutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
           .build())
    return net, _batches((16, 10), 2, seed=4), probe


def case_attention():
    """Pre-LN transformer encoder block, all dropout zero, plain
    attention."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerEncoderLayer)
    conf = (NeuralNetConfiguration.builder().seed(21).updater(Adam(2e-3))
            .weight_init("xavier").list()
            .layer(TransformerEncoderLayer(n_heads=2, d_ff=32,
                                           implementation="plain"))
            .layer(RnnOutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .input_type_recurrent(8).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    return model, _batches((4, 6, 8), 3, seed=5, seq=True), \
        np.random.RandomState(96).rand(2, 6, 8).astype(np.float32)


def case_conv_deep():
    """Separable/depthwise/transpose conv + upsampling/cropping in one
    stack."""
    from deeplearning4j_tpu_torch.nn.layers.convolutional import (
        Cropping2D, Deconvolution2D, DepthwiseConvolution2D,
        SeparableConvolution2D)
    conf = (NeuralNetConfiguration.builder().seed(17).updater(Sgd(0.02))
            .weight_init("relu").list()
            .layer(SeparableConvolution2D(n_out=6, kernel=(3, 3),
                                          activation="relu"))
            .layer(DepthwiseConvolution2D(depth_multiplier=2,
                                          kernel=(3, 3),
                                          activation="relu"))
            .layer(Deconvolution2D(n_out=4, kernel=(2, 2), stride=(2, 2)))
            .layer(Upsampling2D(size=(2, 2)))
            .layer(Cropping2D(cropping=((1, 1), (1, 1))))
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, loss="mcxent",
                               activation="softmax"))
            .input_type_convolutional(10, 10, 2).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    return model, _batches((4, 10, 10, 2), 3, seed=7), \
        np.random.RandomState(94).rand(2, 10, 10, 2).astype(np.float32)


CASES = {"mlp": case_mlp, "cnn2d": case_cnn2d, "rnn": case_rnn,
         "transfer": case_transfer, "attention": case_attention,
         "conv_deep": case_conv_deep}


def run_case(name):
    """The golden runner's ``run_case`` on the port: N fit steps, the
    loss after each, the probe's predictions, the params flattened as
    ``key/name``."""
    model, batches, probe = CASES[name]()
    losses = []
    for x, y in batches:
        model.fit(x, y)
        losses.append(float(model.score_))
    with torch.no_grad():
        preds = model.output(probe).numpy()
    flat = {f"{k}/{n}": t.detach().numpy()
            for k, p in sorted(model.params().items())
            for n, t in sorted(p.items())}
    return flat, preds, np.asarray(losses, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_golden(name):
    data = np.load(os.path.join(BASE, f"{name}.npz"))
    want = {k[2:]: data[k] for k in data.files if k.startswith("p:")}
    got, preds, losses = run_case(name)
    assert len(losses) == N_STEPS
    assert set(got) == set(want), set(got) ^ set(want)
    np.testing.assert_allclose(losses, data["__losses__"], rtol=1e-5,
                               atol=1e-6, err_msg=f"{name}: loss curve")
    np.testing.assert_allclose(preds, data["__preds__"], rtol=1e-4,
                               atol=1e-5, err_msg=f"{name}: predictions")
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}: param {k} after "
                                   f"{N_STEPS} steps")
