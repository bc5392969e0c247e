"""ResNet-50 with the PyTorch/CUDA port: the zoo's ComputationGraph
fitted on a learnable synthetic batch, checkpointed, restored and
served through ``InferenceEngine``, on an NVIDIA GPU, or on the CPU with
``--cpu`` (which also shrinks the images to 32x32).

    python examples/torch/resnet50.py [--cpu] [--steps N]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo import ResNet50


def batch(n, shape, classes, seed=0):
    """Images whose label is the argmax of a fixed projection of their
    quadrant means: a task a few steps can learn."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape).astype(np.float32)
    h, w = shape[0] // 2, shape[1] // 2
    quads = np.concatenate([x[:, i * h:(i + 1) * h, j * w:(j + 1) * w]
                            .mean((1, 2)) for i in (0, 1) for j in (0, 1)],
                           axis=1)
    proj = np.random.RandomState(1).randn(quads.shape[1], classes)
    return x, np.eye(classes, dtype=np.float32)[
        ((quads - quads.mean(0)) @ proj).argmax(1)]


def main(steps: int = 5, device=None, shape=(224, 224, 3), classes=1000,
         n=32):
    net = ResNet50(num_classes=classes, input_shape=shape,
                   device=device).init()
    print(f"ResNet-50: {net.num_params()} params, {len(net._order)} nodes")
    x, y = batch(n, shape, classes)
    losses = []
    for _ in range(steps):
        net.fit(x, y)
        losses.append(net.score_)
    print("loss by step:", [round(v, 4) for v in losses])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50.zip")
        ModelSerializer.write_model(net, path)
        net = ModelSerializer.restore_computation_graph(path, device=device)
    eng = InferenceEngine(net, max_batch_size=8)
    eng.warmup([1, 8])
    probs = eng.predict(x[:3])
    print("predicted classes:", probs.argmax(1).tolist())
    return losses, probs


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    steps = int(sys.argv[sys.argv.index("--steps") + 1]) \
        if "--steps" in sys.argv else 5
    main(steps, device="cpu" if cpu else None,
         shape=(32, 32, 3) if cpu else (224, 224, 3),
         classes=10 if cpu else 1000, n=16 if cpu else 32)
