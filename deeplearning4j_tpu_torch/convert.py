"""Carry JAX weights (and Adam state) into the port.

``params_from_jax`` takes the JAX ``CausalTransformerLM._params``
pytree with numpy leaves (``jax.tree.map(np.asarray, lm._params)``)
and returns the same dict layout holding torch tensors on ``device``.
It is a plain copy: both packages store weights ``[in, out]`` and
apply them as ``x @ W``. A JAX ``QuantWeight`` leaf (the int8 MLP of
``quantize_mlp_weights``, which ``jax.tree.map`` leaves holding numpy
``q`` and ``scale``) becomes the port's
:class:`~.kernels.kv_quant.QuantWeight`. This module imports neither
JAX nor the JAX package; the caller converts the leaves to numpy.

``network_params_from_jax`` does the same for a JAX
``MultiLayerNetwork``'s params (``{"layer_i": {name: leaf}}``; dense
``[in, out]`` and convolution HWIO weights, and the recurrent layers'
``W``, ``U``, ``b``, a GRU's ``b_rec``, a GravesLSTM's peepholes ``p``
and a Bidirectional's ``f_``/``b_``-prefixed pairs, alike),
``network_state_from_jax`` for its layer state (``_net_state``: batch
norm's running ``mean``/``var``) and ``updater_state_from_jax`` for its
updater state (Adam's ``{"layer_i": {"m": {...}, "v": {...}}}``, any
updater's nested dicts), in the layouts ``MultiLayerNetwork.set_params``,
``set_net_state`` and ``set_updater_state`` take. A JAX
``ComputationGraph`` keys the same nested dicts by node name, so
``graph_params_from_jax``, ``graph_state_from_jax`` and
``graph_updater_state_from_jax`` are the same copies, in the layouts of
the port's ``ComputationGraph``. bf16 leaves (a JAX
network built with ``init(jnp.bfloat16)``) cross as bf16 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.kv_quant import QuantWeight


def is_bf16_array(x: np.ndarray) -> bool:
    """A numpy array of bf16 values: ``ml_dtypes.bfloat16`` (what
    ``np.asarray`` of a JAX bf16 array gives) or the raw 2-byte void
    (``|V2``) that ``np.savez`` writes for one and ``np.load`` reads
    back. Decided by the dtype's name and item size, so ``ml_dtypes``
    need not be installed."""
    dt = x.dtype
    return dt.itemsize == 2 and (dt.name == "bfloat16" or dt.kind == "V")


def tensor_from_numpy(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``x``; bf16 arrays (see
    :func:`is_bf16_array`) cross as their bits, through an int16 view."""
    if is_bf16_array(x):
        return torch.from_numpy(
            np.ascontiguousarray(x).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``. A bf16 tensor becomes a 2-byte void
    (``|V2``) array of its bits: numpy has no bf16, and ``np.savez``
    writes exactly these bytes for a JAX bf16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().copy().view(
            np.dtype("V2"))
    return t.numpy().copy()


def _tensor(x, device, where: str) -> torch.Tensor:
    if not isinstance(x, np.ndarray):
        raise TypeError(f"{where}: expected a numpy array, got "
                        f"{type(x).__name__}")
    return tensor_from_numpy(x).to(device)


def _leaf(x, device, where: str):
    if type(x).__name__ == "QuantWeight":
        q = _tensor(x.q, device, f"{where}.q")
        scale = _tensor(x.scale, device, f"{where}.scale")
        if q.dtype != torch.int8 or scale.dtype != torch.float32 \
                or tuple(scale.shape) != tuple(q.shape[1:]):
            raise TypeError(f"{where}: a QuantWeight holds int8 q [in, out] "
                            f"and f32 scale [out], got {q.dtype} "
                            f"{tuple(q.shape)} and {scale.dtype} "
                            f"{tuple(scale.shape)}")
        return QuantWeight(q, scale)
    return _tensor(x, device, where)


def params_from_jax(tree, device="cpu"):
    """Copy a JAX LM params tree (numpy leaves) to torch on ``device``."""
    out = {k: _leaf(v, device, k) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [{k: _leaf(v, device, f"blocks[{i}].{k}")
                      for k, v in bp.items()}
                     for i, bp in enumerate(tree["blocks"])]
    return out


def network_params_from_jax(tree, device="cpu"):
    """Copy a JAX ``MultiLayerNetwork.params()`` tree (numpy leaves) to
    ``{layer_key: {name: tensor}}`` on ``device``."""
    return {key: {n: _tensor(v, device, f"{key}.{n}") for n, v in p.items()}
            for key, p in tree.items()}


def network_state_from_jax(tree, device="cpu"):
    """Copy a JAX ``MultiLayerNetwork._net_state`` tree (numpy leaves)
    to ``{layer_key: {name: tensor}}`` on ``device``."""
    return network_params_from_jax(tree or {}, device)


def updater_state_from_jax(tree, device="cpu"):
    """Copy a JAX ``get_updater_state()`` tree (numpy leaves) to the
    port's layout on ``device``: per layer a nested dict of leaves
    (Adam's ``m``/``v``, Nesterovs' velocities ...), or ``{}`` for a
    stateless updater (Sgd's ``()``)."""
    def conv(x, where):
        if isinstance(x, dict):
            return {k: conv(v, f"{where}.{k}") for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return _tensor(x, device, where)
        if x in ((), None):
            return {}
        raise TypeError(f"{where}: unsupported updater state "
                        f"{type(x).__name__}")
    return {key: conv(st, key) for key, st in tree.items()}


#: a JAX ``ComputationGraph``'s trees, keyed by node name, in the port's
#: ``ComputationGraph`` layouts
graph_params_from_jax = network_params_from_jax
graph_state_from_jax = network_state_from_jax
graph_updater_state_from_jax = updater_state_from_jax
