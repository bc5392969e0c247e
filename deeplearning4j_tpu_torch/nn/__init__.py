"""Neural-network layers, configuration and the sequential network of
the port (the attention blocks of the served causal LM, and the
training core that fits transformer stacks and CNNs)."""
from .conf import MultiLayerConfiguration, NeuralNetConfiguration  # noqa: F401
from .multilayer import MultiLayerNetwork  # noqa: F401

__all__ = ["MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration"]
