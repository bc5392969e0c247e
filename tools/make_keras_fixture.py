"""Write the MobileNetV2 Keras fixture the port's importer is held to.

Builds ``keras.applications.MobileNetV2`` at its published width
(alpha 1.0, 224x224x3, 1,000 classes, 3,538,984 params) and gives it
seeded weights from numpy alone (so the file does not depend on
Keras's own generator): Glorot-uniform kernels, every batch norm a
gamma in [0.6, 1.4) and a beta of N(0, 0.2), and the classifier's bias
N(0, 0.5). The batch norms' moving statistics are then set from a
calibration batch (one training-mode pass at momentum 0, so every
layer's statistics are those of the network below it) and perturbed
(the mean by 0.1 of a channel's deviation, the variance by a factor in
[0.8, 1.25)): an import that mixes up gamma/beta, mean/variance or a
depthwise layout moves the outputs far beyond the tolerance, which a
random-init network with unit statistics (softmax ~0.001 everywhere)
would not show. The classifier's kernel is scaled so the softmax is
peaked. The model is compiled with Adam(1e-4) and categorical
cross-entropy and saved as a legacy ``.h5`` (with its
``training_config``).

The ``.npz`` beside it holds 8 seeded images (``pixels``, uint8; the
model's input is ``pixels / 127.5 - 1``), Keras's softmax outputs
(``probs``) and the 1,280-wide pooled features (``features``, from a
sub-model that ends at the global pooling layer), and ``seed``.

Run (needs Keras; ~1 min on a CPU):
    python tools/make_keras_fixture.py [--seed 0] [--out DIR]
Running it twice gives the same arrays.
"""
import argparse
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "deeplearning4j_tpu_torch", "modelimport", "fixtures")
NAME = "keras_mobilenet_v2_224"
N_IMAGES = 8
N_CALIB = 16
LOGIT_SCALE = 6.0


def images(rs: np.random.RandomState, n: int) -> np.ndarray:
    """Smooth random scenes: a 7x7 colour field upsampled to 224x224,
    with pixel noise, as uint8."""
    field = rs.uniform(0, 255, (n, 7, 7, 3))
    big = np.repeat(np.repeat(field, 32, axis=1), 32, axis=2)
    noisy = big + rs.normal(0, 24, big.shape)
    return np.clip(np.rint(noisy), 0, 255).astype(np.uint8)


def to_input(pixels: np.ndarray) -> np.ndarray:
    return (pixels.astype(np.float32) / np.float32(127.5)
            - np.float32(1.0))


def glorot(rs: np.random.RandomState, shape) -> np.ndarray:
    rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rs.uniform(-lim, lim, shape).astype(np.float32)


def build(seed: int):
    import keras
    keras.utils.set_random_seed(seed)
    model = keras.applications.MobileNetV2(
        alpha=1.0, input_shape=(224, 224, 3), weights=None, classes=1000)
    rs = np.random.RandomState(seed)
    bns = []
    for layer in model.layers:
        if isinstance(layer, keras.layers.BatchNormalization):
            c = layer.gamma.shape[0]
            layer.gamma.assign(rs.uniform(0.6, 1.4, c).astype(np.float32))
            layer.beta.assign(rs.normal(0, 0.2, c).astype(np.float32))
            bns.append(layer)
        elif isinstance(layer, keras.layers.DepthwiseConv2D):
            layer.kernel.assign(glorot(rs, tuple(layer.kernel.shape)))
        elif isinstance(layer, (keras.layers.Conv2D, keras.layers.Dense)):
            layer.kernel.assign(glorot(rs, tuple(layer.kernel.shape)))
            if layer.use_bias:
                n = layer.bias.shape[0]
                layer.bias.assign(rs.normal(0, 0.5 if isinstance(
                    layer, keras.layers.Dense) else 0.1, n)
                    .astype(np.float32))
    # moving statistics from one training-mode pass at momentum 0
    calib = to_input(images(rs, N_CALIB))
    momenta = [b.momentum for b in bns]
    for b in bns:
        b.momentum = 0.0
    model(calib, training=True)
    for b, m in zip(bns, momenta):
        b.momentum = m
        mean = np.asarray(b.moving_mean)
        var = np.asarray(b.moving_variance)
        c = mean.shape[0]
        b.moving_mean.assign((mean + 0.1 * np.sqrt(var)
                              * rs.normal(0, 1, c)).astype(np.float32))
        b.moving_variance.assign(
            (var * rs.uniform(0.8, 1.25, c)).astype(np.float32))
    head = model.layers[-1]
    head.kernel.assign(np.asarray(head.kernel) * np.float32(LOGIT_SCALE))
    model.compile(optimizer=keras.optimizers.Adam(learning_rate=1e-4),
                  loss="categorical_crossentropy")
    pool = next(layer for layer in model.layers if isinstance(
        layer, keras.layers.GlobalAveragePooling2D))
    features = keras.Model(model.inputs, pool.output)
    pixels = images(rs, N_IMAGES)
    x = to_input(pixels)
    probs = np.asarray(model.predict(x, verbose=0), np.float32)
    feats = np.asarray(features.predict(x, verbose=0), np.float32)
    return model, pixels, probs, feats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    model, pixels, probs, feats = build(args.seed)
    os.makedirs(args.out, exist_ok=True)
    h5 = os.path.join(args.out, NAME + ".h5")
    model.save(h5)
    np.savez(os.path.join(args.out, NAME + ".npz"), pixels=pixels,
             probs=probs, features=feats, seed=np.int64(args.seed))
    print(f"{h5}: {model.count_params()} params, "
          f"{os.path.getsize(h5)} bytes; probs max {probs.max():.4f} "
          f"(row maxima {np.round(probs.max(1), 4).tolist()}), "
          f"std {probs.std():.3e}; features mean {feats.mean():.4f} "
          f"std {feats.std():.4f}")


if __name__ == "__main__":
    main()
