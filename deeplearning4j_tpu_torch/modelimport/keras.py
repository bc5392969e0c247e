"""Keras h5 import (counterpart of
``deeplearning4j_tpu/modelimport/keras.py``, its names kept).

Ref: `deeplearning4j-modelimport/.../keras/KerasModelImport.java`
(`importKerasSequentialModelAndWeights` :88 -> MultiLayerNetwork,
`importKerasModelAndWeights` :50 -> ComputationGraph), the per-layer
mappers under `keras/layers/**`, and `KerasModel`/`KerasSequentialModel`.

Reads the h5 directly (config JSON + weight groups) through the port's
own HDF5 reader (``_h5``) — no TF/Keras runtime and no ``h5py`` needed.
Weight layouts transfer verbatim: the port is channels-last with
Keras-identical Dense [in,out], Conv [kh,kw,in,out], and LSTM gate order
(i,f,c,o), so import is a copy, not a transpose dance. Each entry point
takes ``device=`` (the card unless the caller asks for the CPU); the
weights become tensors there in their stored dtype, and the network's
``set_params``/``set_net_state`` take them as its leaves.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _h5

from ..nn import NeuralNetConfiguration
from ..nn.graph import (ComputationGraph, ElementWiseVertex, GraphBuilder,
                        MergeVertex)
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         ConvolutionLayer, DenseLayer, DropoutLayer,
                         EmbeddingLayer, GlobalPoolingLayer, Layer,
                         OutputLayer, SubsamplingLayer, Upsampling2D,
                         ZeroPaddingLayer)
from ..nn.layers.convolutional import (Convolution1D, Convolution3D,
                                       Cropping1D, Cropping2D,
                                       Deconvolution2D,
                                       DepthwiseConvolution2D,
                                       SeparableConvolution2D,
                                       Subsampling1DLayer,
                                       Subsampling3DLayer, Upsampling1D,
                                       Upsampling3D, ZeroPadding1DLayer)
from ..nn.layers.recurrent import (GRU, LSTM, Bidirectional, LastTimeStep,
                                   SimpleRnn)
from ..nn.conf.dropout import (AlphaDropout, GaussianDropout, GaussianNoise,
                               SpatialDropout)
from ..nn.multilayer import MultiLayerNetwork
from ..device import resolve_device

_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "softmax": "softmax", "tanh": "tanh",
    "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid",
    "swish": "swish", "silu": "swish", "gelu": "gelu",
    "leaky_relu": "leakyrelu", "mish": "mish", "exponential": "identity",
}


def _act(cfg, key: str = "activation", default: str = "linear") -> str:
    a = cfg.get(key, default)
    if isinstance(a, dict):  # serialized activation object
        a = a.get("class_name", default).lower()
    if a not in _ACTIVATIONS:
        raise ValueError(f"unsupported Keras {key} {a!r}")
    return _ACTIVATIONS[a]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class _Skip:
    """Marker for config-only Keras layers with no runtime op here
    (InputLayer, Flatten — dense auto-flattens)."""


_LOSS_BY_ACTIVATION = {"softmax": "mcxent", "sigmoid": "xent"}


def _as_output_layer(d: DenseLayer) -> OutputLayer:
    act = d.activation.to_json()
    act_name = act.get("@class", act) if isinstance(act, dict) else act
    loss = _LOSS_BY_ACTIVATION.get(act_name, "mse")
    return OutputLayer(n_out=d.n_out, loss=loss, activation=d.activation,
                       has_bias=d.has_bias, name=d.name)


def _check_masking_semantics_graph(layer_cfgs, mapped):
    """enforce_training_config guards for Masking semantics this import
    cannot reproduce exactly (without enforce these import with the
    documented divergences):

    - a merge vertex consuming a masked branch: keras ANDs masks at
      Concatenate, while the graph forward uses the DL4J MergeVertex OR
      rule (an unmasked sequence sibling clears the merged mask);
    - a sequence-shaped (per-timestep) OUTPUT downstream of Masking:
      keras excludes masked timesteps from the LOSS, but the derived
      mask here lives in the forward pass only — pass an explicit label
      mask to fit() instead."""
    from ..nn.layers import MaskingLayer
    masking_nodes = {nm for nm, l in mapped.items()
                     if isinstance(l, MaskingLayer)}
    if not masking_nodes:
        return
    # transitive downstream closure of the masking nodes
    downstream = set(masking_nodes)
    changed = True
    while changed:
        changed = False
        for lc in layer_cfgs:
            nm = lc["config"].get("name")
            if nm in downstream:
                continue
            if any(i in downstream for i in _inbound_names(lc)):
                downstream.add(nm)
                changed = True
    for lc in layer_cfgs:
        nm = lc["config"].get("name")
        if nm not in downstream or nm in masking_nodes:
            continue
        if lc["class_name"] in _MERGE_VERTICES and any(
                i in downstream for i in _inbound_names(lc)):
            # merging a masked branch with a possibly-unmasked one
            others = [i for i in _inbound_names(lc)
                      if i not in downstream]
            if others:
                raise ValueError(
                    "keras Masking feeding a merge vertex alongside an "
                    "unmasked branch is not mapped exactly (keras ANDs "
                    "masks; the DL4J MergeVertex OR rule applies here) "
                    "— import with enforce_training_config=False to "
                    "accept the divergence")
    # per-timestep outputs: the derived mask does not reach the loss —
    # but only outputs DOWNSTREAM of a Masking node see a derived mask;
    # unrelated unmasked branches are exact and must not be rejected
    out_like = [nm for nm, l in mapped.items()
                if nm in downstream
                and getattr(l, "kind", "") in ("rnnoutput", "rnnloss")]
    if out_like:
        raise ValueError(
            "keras Masking with a per-timestep output is not mapped "
            "exactly: the derived mask is forward-only and does not "
            "reach the loss — pass an explicit label mask to fit(), "
            "or import with enforce_training_config=False")


def _map_layer(class_name: str, cfg: dict) -> Optional[object]:
    """One Keras layer config -> framework Layer (or _Skip / None).
    Ref: the 60+ mappers under `keras/layers/**` — same dispatch shape."""
    name = cfg.get("name")
    if class_name == "InputLayer" or class_name == "Flatten":
        return _Skip()
    if class_name == "Dense":
        return DenseLayer(n_out=cfg["units"], activation=_act(cfg),
                          has_bias=cfg.get("use_bias", True), name=name)
    if class_name in ("Conv2D", "Convolution2D"):
        return ConvolutionLayer(
            n_out=cfg["filters"], kernel=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            padding=cfg.get("padding", "valid"),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True),
            name=name)
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            kernel=_pair(cfg.get("pool_size", 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
            padding=cfg.get("padding", "valid"),
            pooling="max" if class_name.startswith("Max") else "avg",
            name=name)
    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return GlobalPoolingLayer(
            pooling="max" if "Max" in class_name else "avg",
            keep_dims=bool(cfg.get("keepdims", False)), name=name)
    if class_name == "BatchNormalization":
        return BatchNormalization(decay=cfg.get("momentum", 0.99),
                                  eps=cfg.get("epsilon", 1e-3), name=name)
    if class_name == "Dropout":
        return DropoutLayer(dropout=cfg["rate"], name=name)
    if class_name == "Masking":
        from ..nn.layers import MaskingLayer
        return MaskingLayer(mask_value=cfg.get("mask_value", 0.0),
                            name=name)
    if class_name == "Activation":
        return ActivationLayer(activation=_act(cfg), name=name)
    if class_name == "ZeroPadding2D":
        p = cfg.get("padding", 1)
        return ZeroPaddingLayer(padding=p, name=name)
    if class_name == "UpSampling2D":
        return Upsampling2D(size=_pair(cfg.get("size", 2)), name=name)
    if class_name == "Embedding":
        return EmbeddingLayer(n_in=cfg["input_dim"], n_out=cfg["output_dim"],
                              name=name)
    if class_name == "LSTM":
        lstm = LSTM(n_out=cfg["units"], activation=_act(cfg),
                    gate_activation=_act(cfg, "recurrent_activation",
                                         "sigmoid"),
                    name=name)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(lstm, name=name)
        return lstm
    if class_name == "SimpleRNN":
        rnn = SimpleRnn(n_out=cfg["units"], activation=_act(cfg), name=name)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(rnn, name=name)
        return rnn
    if class_name == "GRU":
        gru = GRU(n_out=cfg["units"], activation=_act(cfg),
                  gate_activation=_act(cfg, "recurrent_activation",
                                       "sigmoid"),
                  reset_after=cfg.get("reset_after", True), name=name)
        if not cfg.get("return_sequences", False):
            return LastTimeStep(gru, name=name)
        return gru
    if class_name == "Bidirectional":
        inner_cfg = cfg["layer"]["config"]
        if not inner_cfg.get("return_sequences", False):
            raise ValueError(
                "Bidirectional(return_sequences=False) import is "
                "unsupported: Keras merges each direction's LAST output, "
                "which has no LastTimeStep equivalent here — re-export "
                "with return_sequences=True + a pooling layer")
        inner = _map_layer(cfg["layer"]["class_name"], inner_cfg)
        mode = {"concat": "concat", "sum": "add", "mul": "mul",
                "ave": "average"}.get(cfg.get("merge_mode", "concat"))
        if mode is None:
            raise ValueError(
                f"unsupported Bidirectional merge_mode "
                f"{cfg.get('merge_mode')!r}")
        return Bidirectional(layer=inner, mode=mode, name=name)
    if class_name in ("Conv1D", "Convolution1D"):
        k = cfg["kernel_size"]
        return Convolution1D(
            n_out=cfg["filters"], kernel=k[0] if isinstance(k, list) else k,
            stride=(cfg.get("strides", [1]) or [1])[0]
            if isinstance(cfg.get("strides"), list) else cfg.get("strides", 1),
            padding=cfg.get("padding", "valid"), activation=_act(cfg),
            has_bias=cfg.get("use_bias", True), name=name)
    if class_name in ("SeparableConv2D", "SeparableConvolution2D"):
        return SeparableConvolution2D(
            n_out=cfg["filters"], kernel=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            padding=cfg.get("padding", "valid"),
            depth_multiplier=cfg.get("depth_multiplier", 1),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True),
            name=name)
    if class_name == "DepthwiseConv2D":
        return DepthwiseConvolution2D(
            kernel=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            padding=cfg.get("padding", "valid"),
            depth_multiplier=cfg.get("depth_multiplier", 1),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True),
            name=name)
    if class_name in ("Conv2DTranspose", "Deconvolution2D"):
        return Deconvolution2D(
            n_out=cfg["filters"], kernel=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            padding=cfg.get("padding", "valid"), activation=_act(cfg),
            has_bias=cfg.get("use_bias", True), name=name)
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        pool = cfg.get("pool_size", 2)
        pool = pool[0] if isinstance(pool, list) else pool
        stride = cfg.get("strides") or pool
        stride = stride[0] if isinstance(stride, list) else stride
        return Subsampling1DLayer(
            kernel=pool, stride=stride, padding=cfg.get("padding", "valid"),
            pooling="max" if class_name.startswith("Max") else "avg",
            name=name)
    if class_name == "Cropping2D":
        c = cfg.get("cropping", 0)
        return Cropping2D(cropping=c, name=name)
    if class_name == "Conv3D":
        return Convolution3D(
            n_out=cfg["filters"], kernel=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1, 1))),
            padding=cfg.get("padding", "valid"),
            dilation=tuple(cfg.get("dilation_rate", (1, 1, 1))),
            activation=_act(cfg), has_bias=cfg.get("use_bias", True),
            name=name)
    if class_name in ("MaxPooling3D", "AveragePooling3D"):
        pool = tuple(cfg.get("pool_size", (2, 2, 2)))
        return Subsampling3DLayer(
            kernel=pool, stride=tuple(cfg.get("strides") or pool),
            padding=cfg.get("padding", "valid"),
            pooling="max" if class_name.startswith("Max") else "avg",
            name=name)
    if class_name == "UpSampling1D":
        return Upsampling1D(size=int(cfg.get("size", 2)), name=name)
    if class_name == "UpSampling3D":
        return Upsampling3D(size=tuple(cfg.get("size", (2, 2, 2))),
                            name=name)
    if class_name == "ZeroPadding1D":
        p = cfg.get("padding", 1)
        p = (p, p) if isinstance(p, int) else tuple(p)
        return ZeroPadding1DLayer(padding=p, name=name)
    if class_name == "Cropping1D":
        c = cfg.get("cropping", 0)
        c = (c, c) if isinstance(c, int) else tuple(c)
        return Cropping1D(cropping=c, name=name)
    if class_name == "Reshape":
        from ..nn.layers.misc import ReshapeLayer
        return ReshapeLayer(target_shape=tuple(cfg["target_shape"]),
                            name=name)
    if class_name == "ReLU":
        # keras.layers.ReLU(max_value, negative_slope, threshold) — the
        # max_value=6 form is MobileNet's ReLU6
        mv = cfg.get("max_value")
        ns = float(cfg.get("negative_slope", 0.0) or 0.0)
        th = float(cfg.get("threshold", 0.0) or 0.0)
        if ns == 0.0 and th == 0.0 and mv is None:
            return ActivationLayer(activation="relu", name=name)
        if ns == 0.0 and th == 0.0 and float(mv) == 6.0:
            return ActivationLayer(activation="relu6", name=name)
        if mv is None and th == 0.0:
            return ActivationLayer(
                activation={"@class": "leakyrelu", "alpha": ns},
                name=name)
        raise ValueError(f"unsupported ReLU config {cfg!r}")
    if class_name == "LeakyReLU":
        alpha = cfg.get("negative_slope", cfg.get("alpha", 0.3))
        return ActivationLayer(
            activation={"@class": "leakyrelu", "alpha": float(alpha)},
            name=name)
    if class_name == "ELU":
        return ActivationLayer(
            activation={"@class": "elu",
                        "alpha": float(cfg.get("alpha", 1.0))},
            name=name)
    if class_name == "GaussianNoise":
        return DropoutLayer(dropout=GaussianNoise(cfg.get("stddev", 0.1)),
                            name=name)
    if class_name == "GaussianDropout":
        return DropoutLayer(dropout=GaussianDropout(cfg.get("rate", 0.5)),
                            name=name)
    if class_name == "AlphaDropout":
        return DropoutLayer(dropout=AlphaDropout(cfg.get("rate", 0.05)),
                            name=name)
    if class_name == "SpatialDropout2D":
        return DropoutLayer(dropout=SpatialDropout(cfg.get("rate", 0.5)),
                            name=name)
    raise ValueError(f"unsupported Keras layer type {class_name!r} "
                     f"(layer {name!r})")


# merge layers -> graph vertices (functional models only)
_MERGE_VERTICES = {
    "Concatenate": lambda cfg: MergeVertex(),
    "Add": lambda cfg: ElementWiseVertex("add"),
    "Subtract": lambda cfg: ElementWiseVertex("subtract"),
    "Multiply": lambda cfg: ElementWiseVertex("product"),
    "Average": lambda cfg: ElementWiseVertex("average"),
    "Maximum": lambda cfg: ElementWiseVertex("max"),
}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _layer_weights(f: _h5.File, layer_name: str) -> Dict[str, np.ndarray]:
    """Collect datasets under model_weights/<layer> keyed by basename
    (Keras 3 nests groups; Keras 2 uses weight_names attrs — walking the
    tree handles both)."""
    out: Dict[str, np.ndarray] = {}
    grp = f["model_weights"]
    if layer_name not in grp:
        return out

    def visit(name, obj):
        if isinstance(obj, _h5.Dataset):
            base = name.split("/")[-1].split(":")[0]
            out[base] = np.asarray(obj)
            # Bidirectional wrappers nest forward_*/backward_* groups
            # whose basenames collide; keep direction-prefixed copies
            if "forward" in name:
                out[f"forward:{base}"] = out[base]
            elif "backward" in name:
                out[f"backward:{base}"] = out[base]
    grp[layer_name].visititems(visit)
    return out


def _dw_kernel(w):
    """Keras depthwise kernel (kh, kw, C, mult) -> grouped-conv HWIO
    (kh, kw, 1, C*mult) with C-major output ordering (matches XLA's
    feature_group_count channel layout)."""
    kh, kw_, c, m = w.shape
    return w.reshape(kh, kw_, 1, c * m)


_PARAM_MAP = {
    # our param name -> keras dataset basename (optionally with a layout
    # transform), per layer kind
    "dense": {"W": "kernel", "b": "bias"},
    "output": {"W": "kernel", "b": "bias"},
    "conv2d": {"W": "kernel", "b": "bias"},
    "conv1d": {"W": "kernel", "b": "bias"},
    "conv3d": {"W": "kernel", "b": "bias"},
    "batchnorm": {"gamma": "gamma", "beta": "beta"},
    "embedding": {"W": "embeddings"},
    "lstm": {"W": "kernel", "U": "recurrent_kernel", "b": "bias"},
    "simplernn": {"W": "kernel", "U": "recurrent_kernel", "b": "bias"},
    # keras GRU with reset_after stores bias as (2, 3H): row 0 input
    # bias, row 1 recurrent bias
    "gru": {"W": "kernel", "U": "recurrent_kernel",
            "b": ("bias", lambda w: w[0] if w.ndim == 2 else w),
            "b_rec": ("bias", lambda w: w[1] if w.ndim == 2 else
                      np.zeros_like(w))},
    # keras Conv2DTranspose kernel is (kh, kw, out, in) applied with
    # transpose_kernel=True; our deconv2d runs lax.conv_transpose with a
    # plain HWIO kernel, so convert by flipping the spatial dims and
    # swapping in/out (verified equivalent vs real Keras)
    "deconv2d": {"W": ("kernel",
                       lambda w: np.transpose(w[::-1, ::-1], (0, 1, 3, 2))),
                 "b": "bias"},
    # Keras 2 names the depthwise kernel "depthwise_kernel"; Keras 3's
    # h5 export calls it plain "kernel" — accept either
    "depthwiseconv2d": {"W": (["depthwise_kernel", "kernel"], _dw_kernel),
                        "b": "bias"},
    "sepconv2d": {"dW": ("depthwise_kernel", _dw_kernel),
                  "pW": "pointwise_kernel", "b": "bias"},
}


def _translate_params(kind: str, ours: dict, keras_w: Dict[str, np.ndarray],
                      layer_name: str, layer=None, device=None) -> dict:
    """Our params of one layer with Keras's weights in place of the
    drawn ones (tensors on ``device``, the templates' when None)."""
    if kind == "bidirectional":
        # split direction-prefixed datasets, translate each half with the
        # wrapped layer's own mapping, re-prefix to our f_/b_ params.
        # Unwrap MaskZeroLayer/LastTimeStep first: `layer` may be the
        # wrapper, and reading .layer.kind off the wrapper returns
        # "bidirectional" again (double-split drops every weight)
        bidir = _unwrap(layer) if layer is not None else None
        inner_kind = bidir.layer.kind if bidir is not None else "lstm"
        fwd = {k.split(":", 1)[1]: v for k, v in keras_w.items()
               if k.startswith("forward:")}
        bwd = {k.split(":", 1)[1]: v for k, v in keras_w.items()
               if k.startswith("backward:")}
        ours_f = {k[2:]: v for k, v in ours.items() if k.startswith("f_")}
        ours_b = {k[2:]: v for k, v in ours.items() if k.startswith("b_")}
        tf_ = _translate_params(inner_kind, ours_f, fwd, layer_name,
                                device=device)
        tb_ = _translate_params(inner_kind, ours_b, bwd, layer_name,
                                device=device)
        return {**{f"f_{k}": v for k, v in tf_.items()},
                **{f"b_{k}": v for k, v in tb_.items()}}
    mapping = _PARAM_MAP.get(kind)
    if mapping is None:
        if ours:
            raise ValueError(f"no weight mapping for layer kind {kind!r} "
                             f"({layer_name!r})")
        return ours
    new = {}
    for pname, template in ours.items():
        spec = mapping.get(pname)
        if isinstance(spec, tuple):
            kname, transform = spec
        else:
            kname, transform = spec, None
        if isinstance(kname, list):  # candidate names (Keras 2 vs 3)
            kname = next((k for k in kname if k in keras_w), None)
        if kname is None or kname not in keras_w:
            new[pname] = template  # keep init (e.g. missing bias)
            continue
        w = keras_w[kname]
        if transform is not None:
            w = transform(np.asarray(w))
        if tuple(w.shape) != tuple(template.shape):
            raise ValueError(
                f"shape mismatch importing {layer_name!r}.{pname}: "
                f"keras {w.shape} vs model {tuple(template.shape)}")
        new[pname] = torch.as_tensor(
            np.ascontiguousarray(w, w.dtype.newbyteorder("=")),
            device=template.device if device is None else device)
    return new


def _bn_state(keras_w, device=None) -> Optional[dict]:
    if "moving_mean" in keras_w:
        return {"mean": torch.as_tensor(keras_w["moving_mean"],
                                        device=device),
                "var": torch.as_tensor(keras_w["moving_variance"],
                                       device=device)}
    return None


def _unwrap(layer):
    """Peel recurrent wrappers (MaskZeroLayer(LastTimeStep(LSTM)) ...)."""
    from ..nn.layers.recurrent import MaskZeroLayer
    while isinstance(layer, (LastTimeStep, MaskZeroLayer)):
        layer = layer.layer
    return layer


def _wrapped_kind(layer) -> str:
    return _unwrap(layer).kind


def _input_type(list_builder, batch_shape):
    from ..nn.conf import InputType
    dims = [d for d in batch_shape[1:]]
    if len(dims) == 4:
        return list_builder.input_type(InputType.convolutional3d(*dims))
    if len(dims) == 3:
        return list_builder.input_type_convolutional(*dims)
    if len(dims) == 2:
        return list_builder.input_type_recurrent(dims[1], timesteps=dims[0])
    return list_builder.input_type_feed_forward(dims[0])


def _map_training_config(f, enforce: bool):
    """Map the h5 `training_config` attr (model.compile state) to
    (updater, loss_name). Ref: KerasModelImport's enforceTrainingConfig
    + KerasOptimizerUtils/KerasLossUtils — when `enforce` is False,
    unmappable pieces are skipped; when True they raise."""
    from .. import learning as U
    raw = f.attrs.get("training_config")
    if raw is None:
        if enforce:
            raise ValueError("model was saved without training_config "
                             "(not compiled) but enforce_training_config"
                             "=True")
        return None, None
    tc = json.loads(raw if isinstance(raw, str) else raw.decode())
    upd = None
    oc = tc.get("optimizer_config") or {}
    name = str(oc.get("class_name") or "").lower()
    ocfg = (oc.get("config") or {})
    # Keras 3 stores 'learning_rate'; Keras 2 h5 files store 'lr'
    lr = ocfg.get("learning_rate", ocfg.get("lr", 1e-3))
    if isinstance(lr, dict):  # lr schedule object
        if enforce:
            raise ValueError("keras learning-rate schedules are not "
                             "mapped; resolve to a constant lr first")
        lr = (lr.get("config") or {}).get("initial_learning_rate", 1e-3)
    lr = float(lr)
    if name == "adam":
        upd = U.Adam(lr, ocfg.get("beta_1", 0.9),
                     ocfg.get("beta_2", 0.999),
                     ocfg.get("epsilon", 1e-7))
    elif name == "sgd":
        mom = float(ocfg.get("momentum", 0.0) or 0.0)
        upd = U.Nesterovs(lr, mom) if mom else U.Sgd(lr)
    elif name == "rmsprop":
        upd = U.RmsProp(lr, ocfg.get("rho", 0.9),
                        ocfg.get("epsilon", 1e-7))
    elif name == "adagrad":
        upd = U.AdaGrad(lr)
    elif name == "adamax":
        upd = U.AdaMax(lr)
    elif name == "nadam":
        upd = U.Nadam(lr)
    elif name and enforce:
        raise ValueError(f"unsupported keras optimizer {name!r}")
    def _loss_str(sp):
        # a loss-object dict carries class_name/config.name; anything
        # else string-like passes through
        if isinstance(sp, dict):
            cfg_v = sp.get("config")
            name = cfg_v.get("name") if isinstance(cfg_v, dict) else None
            cls_v = sp.get("class_name")
            sp = name or (cls_v if isinstance(cls_v, str) else None)
        return sp if isinstance(sp, str) else None

    def _check_sparse(l):
        if l == "sparse_categorical_crossentropy":
            if enforce:
                raise ValueError(
                    "sparse_categorical_crossentropy is not mapped (the "
                    "mcxent loss expects one-hot labels; integer-label "
                    "sparse CE would silently optimize a wrong objective) "
                    "— one-hot the labels and recompile, or import with "
                    "enforce_training_config=False and set the loss")
            return None
        return l

    raw_loss = tc.get("loss")
    # a serialized loss OBJECT has a class_name string (keras serde
    # invariant); a per-output dict maps output-layer names to specs.
    # Checking the class_name TYPE keeps an output literally named
    # "config" or "class_name" from being misparsed as a loss object.
    if (isinstance(raw_loss, dict)
            and not isinstance(raw_loss.get("class_name"), str)):
        # keras multi-output per-output dict form {'out_name': spec}:
        # map each entry; the whole dict is unmappable only if some
        # ENTRY is (advisor r4: dropping a fully-mappable dict left
        # compiled functional models without restored losses)
        loss = {k: _check_sparse(_loss_str(v))
                for k, v in raw_loss.items()}
        if not loss or any(v is None for v in loss.values()):
            loss = None
    else:
        loss = _check_sparse(_loss_str(raw_loss)) \
            if raw_loss is not None else None
    if loss is None and raw_loss is not None and enforce:
        raise ValueError(f"unsupported keras loss spec {raw_loss!r}")
    return upd, loss


class KerasModelImport:
    """Ref: KerasModelImport.java:50 (functional) / :88 (sequential).
    Every entry point builds its network on ``device`` (``cuda`` by
    default; without a card it raises unless given ``"cpu"``)."""

    # -- sequential -> MultiLayerNetwork -------------------------------
    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, enforce_training_config: bool = False,
            device=None) -> MultiLayerNetwork:
        device = resolve_device(device)
        with _h5.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            if cfg["class_name"] != "Sequential":
                raise ValueError(
                    f"{path} is a {cfg['class_name']} model; use "
                    "import_keras_model_and_weights")
            layer_cfgs = cfg["config"]["layers"]
            batch_shape = None
            mapped: List[Tuple[str, object]] = []
            for lc in layer_cfgs:
                c = lc["config"]
                if lc["class_name"] == "InputLayer":
                    batch_shape = c.get("batch_shape") or c.get(
                        "batch_input_shape")
                if batch_shape is None:
                    bs = c.get("batch_shape") or c.get("batch_input_shape")
                    if bs:
                        batch_shape = bs
                layer = _map_layer(lc["class_name"], c)
                if not isinstance(layer, _Skip):
                    mapped.append((c.get("name"), layer))
            if batch_shape is None:
                raise ValueError("could not determine model input shape")

            # make the head trainable: final Dense -> OutputLayer with the
            # loss implied by its activation (ref: KerasLoss mapping /
            # enforceTrainingConfig behavior)
            if mapped and type(mapped[-1][1]) is DenseLayer:
                nm, d = mapped[-1]
                mapped[-1] = (nm, _as_output_layer(d))
            if enforce_training_config:
                from ..nn.layers import MaskingLayer
                has_masking = any(isinstance(l, MaskingLayer)
                                  for _, l in mapped)
                if has_masking and mapped and getattr(
                        mapped[-1][1], "kind", "") in ("rnnoutput",
                                                       "rnnloss"):
                    raise ValueError(
                        "keras Masking with a per-timestep output is "
                        "not mapped exactly: the derived mask is "
                        "forward-only and does not reach the loss — "
                        "pass an explicit label mask to fit(), or "
                        "import with enforce_training_config=False")

            # restore the compile-time training config (optimizer + loss)
            # so an imported model fine-tunes with the same settings
            upd, loss_name = _map_training_config(
                f, enforce_training_config)
            b = NeuralNetConfiguration.builder()
            if upd is not None:
                b = b.updater(upd)
            lb = b.list()
            for _, layer in mapped:
                lb = lb.layer(layer)
            if isinstance(loss_name, dict):
                # per-output dict on a Sequential = one output
                loss_name = (next(iter(loss_name.values()))
                             if len(loss_name) == 1 else None)
            if loss_name is not None and mapped:
                if not hasattr(mapped[-1][1], "loss"):
                    if enforce_training_config:
                        raise ValueError(
                            "compiled loss cannot be attached: the "
                            "final imported layer "
                            f"({type(mapped[-1][1]).__name__}) is not "
                            "an output layer")
                else:
                    from .. import losses as _L
                    try:
                        mapped[-1][1].loss = _L.get(loss_name)
                    except Exception:
                        if enforce_training_config:
                            raise
            lb = _input_type(lb, batch_shape)
            net = MultiLayerNetwork(lb.build(), device=device).init()

            # copy weights
            params, state = dict(net._params), dict(net._net_state)
            for i, (kname, layer) in enumerate(mapped):
                key = net._layer_keys[i]
                keras_w = _layer_weights(f, kname)
                kind = _wrapped_kind(layer)
                if key in params:
                    params[key] = _translate_params(
                        kind, params[key], keras_w, kname,
                        layer=layer, device=device)
                if kind == "batchnorm":
                    st = _bn_state(keras_w, device)
                    if st is not None:
                        state[key] = st
            net.set_params(params)
            net.set_net_state(state)
        return net

    # -- functional -> ComputationGraph --------------------------------
    @staticmethod
    def import_keras_model_and_weights(
            path: str, enforce_training_config: bool = False,
            device=None) -> ComputationGraph:
        device = resolve_device(device)
        with _h5.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            if cfg["class_name"] == "Sequential":
                raise ValueError(
                    f"{path} is Sequential; use "
                    "import_keras_sequential_model_and_weights")
            gcfg = cfg["config"]
            # restore compile-time optimizer (+ loss, attached below)
            upd, loss_name = _map_training_config(
                f, enforce_training_config)
            base = NeuralNetConfiguration.builder()
            if upd is not None:
                base = base.updater(upd)
            builder = GraphBuilder(base)
            input_names = []
            mapped: Dict[str, object] = {}
            shapes: Dict[str, list] = {}
            # positional references from DATA-path nodes only: the
            # aux mask subgraph (NotEqual -> Any) references itself
            # positionally, which must not veto dropping it
            _aux = {lc2["config"].get("name") for lc2 in gcfg["layers"]
                    if lc2["class_name"] in ("NotEqual", "Any")}
            _positional_refs = {n for lc2 in gcfg["layers"]
                                if lc2["config"].get("name") not in _aux
                                for n in _inbound_names(lc2)}
            for lc in gcfg["layers"]:
                c = lc["config"]
                nm = c["name"]
                inbound = _inbound_names(lc)
                if lc["class_name"] == "InputLayer":
                    input_names.append(nm)
                    shapes[nm] = c.get("batch_shape") or c.get(
                        "batch_input_shape")
                    continue
                if lc["class_name"] in ("NotEqual", "Any"):
                    # keras-3 functional serialization materializes the
                    # Masking mask computation as auxiliary NotEqual/Any
                    # nodes wired to consumers via kwargs only; our
                    # MaskingLayer derives the mask in-band, so these
                    # nodes have no data-path consumers — drop them.
                    # Safety: a model legitimately using
                    # keras.ops.not_equal/any IN the data path would be
                    # positionally referenced — refuse those clearly
                    if nm in _positional_refs:
                        raise ValueError(
                            f"unsupported Keras layer type "
                            f"{lc['class_name']!r} in the data path "
                            f"(layer {nm!r})")
                    continue
                if lc["class_name"] in _MERGE_VERTICES:
                    builder.add_vertex(nm, _MERGE_VERTICES[lc["class_name"]](c),
                                       *inbound)
                    continue
                layer = _map_layer(lc["class_name"], c)
                if isinstance(layer, _Skip):
                    # passthrough: alias by scale-1 vertex
                    from ..nn.graph import ScaleVertex
                    builder.add_vertex(nm, ScaleVertex(1.0), *inbound)
                    continue
                mapped[nm] = layer
                builder.add_layer(nm, layer, *inbound)
            if enforce_training_config:
                _check_masking_semantics_graph(gcfg["layers"], mapped)
            builder.add_inputs(*input_names)
            outs = gcfg["output_layers"]
            if (len(outs) >= 2 and isinstance(outs[0], str)
                    and isinstance(outs[1], int)):
                outs = [outs]  # single output stored flat: [name, 0, 0]
            out_names = [_node_name(o) for o in outs]
            builder.set_outputs(*out_names)
            # make output nodes trainable: final Dense -> OutputLayer
            # (same conversion the sequential path applies; without it
            # the imported graph has no loss head and cannot fit)
            for onm in out_names:
                ol = mapped.get(onm)
                if type(ol) is DenseLayer:
                    new = _as_output_layer(ol)
                    mapped[onm] = new
                    builder._nodes[onm].layer = new
            from ..nn.conf import InputType
            types = []
            for nm in input_names:
                dims = shapes[nm][1:]
                if len(dims) == 3:
                    types.append(InputType.convolutional(*dims))
                elif len(dims) == 2:
                    types.append(InputType.recurrent(dims[1], dims[0]))
                else:
                    types.append(InputType.feed_forward(dims[0]))
            builder.set_input_types(*types)
            if loss_name is not None:
                from .. import losses as _L
                for onm in out_names:
                    ol = mapped.get(onm)
                    # per-output dict form: each output gets ITS entry
                    this_loss = (loss_name.get(onm)
                                 if isinstance(loss_name, dict)
                                 else loss_name)
                    if this_loss is None:
                        if enforce_training_config:
                            raise ValueError(
                                "compiled per-output loss dict has no "
                                f"entry for output {onm!r}")
                        continue
                    if ol is None or not hasattr(ol, "loss"):
                        if enforce_training_config:
                            raise ValueError(
                                "compiled loss cannot be attached: "
                                f"output node {onm!r} is not an output "
                                "layer")
                        continue
                    try:
                        ol.loss = _L.get(this_loss)
                    except Exception:
                        if enforce_training_config:
                            raise
            graph = ComputationGraph(builder.build(), device=device).init()

            params, state = dict(graph._params), dict(graph._net_state)
            for nm, layer in mapped.items():
                keras_w = _layer_weights(f, nm)
                kind = _wrapped_kind(layer)
                if nm in params:
                    params[nm] = _translate_params(
                        kind, params[nm], keras_w, nm,
                        layer=layer, device=device)
                if kind == "batchnorm":
                    st = _bn_state(keras_w, device)
                    if st is not None:
                        state[nm] = st
            graph.set_params(params)
            graph.set_net_state(state)
        return graph

    # convenience dispatch (ref: importKerasModelAndWeights handles both)
    @staticmethod
    def import_model(path: str, device=None):
        with _h5.File(path, "r") as f:
            cls = json.loads(f.attrs["model_config"])["class_name"]
        if cls == "Sequential":
            return KerasModelImport.\
                import_keras_sequential_model_and_weights(path,
                                                          device=device)
        return KerasModelImport.import_keras_model_and_weights(
            path, device=device)


def _node_name(entry) -> str:
    """output_layers entries: [name, node_idx, tensor_idx] (Keras 2/3)."""
    if isinstance(entry, (list, tuple)):
        return entry[0]
    return entry


def _inbound_names(layer_cfg: dict) -> List[str]:
    """Extract predecessor layer names from inbound_nodes — handles both
    Keras 2 nested lists and Keras 3 keras_history dicts."""
    names: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            if "keras_history" in obj:
                names.append(obj["keras_history"][0])
            elif "args" in obj:
                # keras-3 node form {'args': [...], 'kwargs': {...}}:
                # only positional args are DATA inputs — kwargs carry
                # auxiliary wiring (e.g. the mask tensor from the
                # serialized Masking infrastructure's NotEqual/Any
                # nodes, which the importer drops)
                walk(obj["args"])
            else:
                for v in obj.values():
                    walk(v)
        elif isinstance(obj, (list, tuple)):
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int)):
                names.append(obj[0])  # Keras 2: [name, node, tensor, {}]
            else:
                for v in obj:
                    walk(v)

    walk(layer_cfg.get("inbound_nodes", []))
    # dedupe preserving order (multi-arg merges list each input once)
    seen = set()
    out = []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out
