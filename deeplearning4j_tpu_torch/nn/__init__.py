"""Neural-network layers, configuration, the sequential network and the
DAG network of the port (the attention blocks of the served causal LM,
and the training core that fits transformer stacks, CNNs and graphs)."""
from .conf import MultiLayerConfiguration, NeuralNetConfiguration  # noqa: F401
from .graph import (ComputationGraph,  # noqa: F401
                    ComputationGraphConfiguration, GraphBuilder)
from .multilayer import MultiLayerNetwork  # noqa: F401

__all__ = ["ComputationGraph", "ComputationGraphConfiguration",
           "GraphBuilder", "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration"]
