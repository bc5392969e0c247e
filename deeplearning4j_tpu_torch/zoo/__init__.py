"""Model zoo of the port (counterpart of ``deeplearning4j_tpu/zoo``):
the ``ZooModel`` base, the sequential CNNs of ``simple.py`` (LeNet,
SimpleCNN, AlexNet, VGG16, VGG19, Darknet19), the graphs of
``resnet.py`` (ResNet50), ``inception.py`` (InceptionResNetV1,
FaceNetNN4Small2) and ``advanced.py`` (SqueezeNet, UNet, Xception,
NASNet), and the causal transformer LM of ``transformer_lm.py``. Each
``init()`` returns an initialized ``MultiLayerNetwork`` or
``ComputationGraph`` on the model's device (the GPU unless
``device="cpu"``). ``ALL_MODELS`` holds the JAX zoo's sixteen names,
each of which builds (``simple.py`` also holds TinyYOLO and YOLO2).

Pretrained weights load from a local ``.npz`` (the JAX package's
layout: ``param/<layer>/<name>`` and ``state/<layer>/<name>``) whose
sha256 sidecar, when present, must match; nothing is downloaded.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch


class ZooModel:
    """Base zoo model."""

    name = "zoo"

    def __init__(self, num_classes: int = 1000, seed: int = 1234,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 updater=None, device=None):
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        if input_shape is not None:
            self.input_shape = tuple(input_shape)
        self.updater = updater
        self.device = device

    def init(self):
        """Build and initialize the network."""
        raise NotImplementedError

    def _net(self, conf):
        from ..nn import MultiLayerNetwork
        return MultiLayerNetwork(conf, device=self.device).init()

    def _graph(self, conf):
        from ..nn import ComputationGraph
        return ComputationGraph(conf, device=self.device).init()

    def _updater(self):
        from ..learning import Adam
        return self.updater if self.updater is not None else Adam(1e-3)

    def pretrained_cache_path(self) -> str:
        return os.path.expanduser(
            f"~/.deeplearning4j_tpu/zoo/{self.name}.npz")

    def save_pretrained(self, model, path: Optional[str] = None) -> str:
        """Write a model's params and layer state as the ``.npz`` that
        :meth:`init_pretrained` loads, with a ``.sha256`` sidecar."""
        path = path or self.pretrained_cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        flat = {f"param/{k}": v for k, v in _flatten("", model.params())
                .items()}
        flat.update({f"state/{k}": v for k, v in
                     _flatten("", model.get_net_state()).items()})
        np.savez(path, **{k: v.detach().cpu().numpy()
                          for k, v in flat.items()})
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        with open(path + ".sha256", "w") as f:
            f.write(sha + "\n")
        return path

    def init_pretrained(self, path: Optional[str] = None):
        """The initialized model with every param and state leaf loaded
        from ``path``; a digest mismatch, a missing leaf or a wrong
        shape raises instead of half-loading."""
        path = path or self.pretrained_cache_path()
        model = self.init()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no pretrained weights cached at {path}; nothing is "
                f"downloaded")
        sha_path = path + ".sha256"
        if os.path.exists(sha_path):
            with open(sha_path) as f:
                want = f.read().split()[0]
            with open(path, "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
            if got != want:
                raise IOError(f"pretrained checksum mismatch for {path}: "
                              f"{got} != {want}")
        blob = np.load(path, allow_pickle=False)
        trees = {"param": model.params(), "state": model.get_net_state()}
        want = {f"{kind}/{k}": v for kind, tree in trees.items()
                for k, v in _flatten("", tree).items()}
        missing = [k for k in want if k not in blob.files]
        if missing:
            raise ValueError(f"pretrained blob {path} is missing params: "
                             f"{missing[:5]}")
        bad = [k for k, v in want.items()
               if blob[k].shape != tuple(v.shape)]
        if bad:
            raise ValueError(f"pretrained blob {path} has mismatched "
                             f"shapes for: {bad[:5]}")
        with torch.no_grad():
            for k, v in want.items():
                v.copy_(torch.from_numpy(blob[k]).to(v.device, v.dtype))
        return model


def _flatten(prefix, tree):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(key, v))
        else:
            out[key] = v
    return out


from .simple import (AlexNet, Darknet19, LeNet, SimpleCNN,  # noqa: E402,F401
                     TextGenerationLSTM, TinyYOLO, VGG16, VGG19, YOLO2)
from .resnet import ResNet50  # noqa: E402,F401
from .inception import FaceNetNN4Small2, InceptionResNetV1  # noqa: E402,F401
from .advanced import NASNet, SqueezeNet, UNet, Xception  # noqa: E402,F401

ALL_MODELS = (AlexNet, Darknet19, FaceNetNN4Small2, InceptionResNetV1, LeNet,
              NASNet, ResNet50, SimpleCNN, SqueezeNet, TextGenerationLSTM,
              TinyYOLO, UNet, VGG16, VGG19, Xception, YOLO2)
