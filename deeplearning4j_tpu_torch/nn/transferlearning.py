"""Transfer learning (counterpart of
``deeplearning4j_tpu/nn/transferlearning.py``): a builder over a trained
network that freezes a prefix (``set_feature_extractor``), drops layers
from the output end, appends new layers and overrides the updater and
seed (``FineTuneConfiguration``).

The rebuilt network is a fresh ``init`` of the new configuration on the
base network's device, with the kept layers' params and layer state
copied in as clones (never the base network's tensors) and the updater
state started afresh for every layer, frozen ones included, as in JAX.
Frozen layers are wrapped in :class:`~.layers.FrozenLayer`, whose params
get zero gradients.
"""
from __future__ import annotations

import copy
from typing import List, Optional

from .. import learning
from .conf import MultiLayerConfiguration
from .layers import FrozenLayer, Layer
from .multilayer import MultiLayerNetwork


def _clone_tree(tree):
    return {n: t.detach().clone() for n, t in tree.items()}


class FineTuneConfiguration:
    """Overrides applied to the whole rebuilt network: the updater (and
    so its learning rate) and the seed."""

    def __init__(self, updater=None, seed: Optional[int] = None):
        self.updater = learning.get(updater) if updater is not None \
            else None
        self.seed = seed

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def build(self):
            return FineTuneConfiguration(**self._kw)

    @staticmethod
    def builder():
        return FineTuneConfiguration.Builder()


class TransferLearning:
    """``TransferLearning.builder(net)...build()``."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            if net._params is None:
                net.init()
            self._net = net
            self._layers: List[Layer] = [copy.deepcopy(l)
                                         for l in net.layers]
            keys = net._layer_keys
            # per original layer: a clone of its params and state, or
            # None (no params, or removed)
            self._params: List = [
                _clone_tree(net._params[k]) if k in net._params else None
                for k in keys]
            self._state: List = [
                _clone_tree(net._net_state[k]) if k in net._net_state
                else None for k in keys]
            self._freeze_until = -1
            self._fine_tune: Optional[FineTuneConfiguration] = None

        def fine_tune_configuration(self, cfg: FineTuneConfiguration):
            self._fine_tune = cfg
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers 0 .. ``layer_index``."""
            self._freeze_until = layer_index
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            for _ in range(n):
                self._layers.pop()
                self._params.pop()
                self._state.pop()
            return self

        def add_layer(self, layer: Layer):
            self._layers.append(layer)
            self._params.append(None)
            self._state.append(None)
            return self

        def build(self) -> MultiLayerNetwork:
            old_conf = self._net.conf
            layers: List[Layer] = [
                FrozenLayer(l) if i <= self._freeze_until
                and not isinstance(l, FrozenLayer) else l
                for i, l in enumerate(self._layers)]
            updater, seed = old_conf.updater, old_conf.seed
            if self._fine_tune is not None:
                if self._fine_tune.updater is not None:
                    updater = self._fine_tune.updater
                if self._fine_tune.seed is not None:
                    seed = self._fine_tune.seed
            conf = MultiLayerConfiguration(
                layers=layers, seed=seed, updater=updater,
                defaults=old_conf.defaults,
                input_type=old_conf.input_type,
                tbptt_fwd_length=old_conf.tbptt_fwd_length,
                tbptt_bwd_length=old_conf.tbptt_bwd_length,
                max_grad_norm=old_conf.max_grad_norm,
                grad_clip_value=old_conf.grad_clip_value,
                dtype=old_conf.dtype, remat=old_conf.remat)
            net = MultiLayerNetwork(conf, device=self._net.device).init()
            params = dict(net._params)
            state = dict(net._net_state)
            for i, (p, s) in enumerate(zip(self._params, self._state)):
                key = net._layer_keys[i]
                if p is not None and key in params:
                    params[key] = p
                if s is not None and key in state:
                    state[key] = s
            # set_params starts every layer's updater state afresh
            net.set_params(params)
            net.set_net_state(state)
            return net

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearning.Builder":
        return TransferLearning.Builder(net)
