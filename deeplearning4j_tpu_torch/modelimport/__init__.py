"""Model import (counterpart of ``deeplearning4j_tpu/modelimport``).

Ref: `deeplearning4j-modelimport/.../keras/KerasModelImport.java:50,88`
(h5 -> MultiLayerNetwork / ComputationGraph, 60+ layer mappers) and
`nd4j-api/.../imports/graphmapper/tf/TFGraphMapper.java:59`
(TF GraphDef -> SameDiff). Keras files are read by the port's own HDF5
reader (``_h5``); TF import waits for SameDiff.
"""
from .keras import KerasModelImport


class TFGraphMapper:
    """TF GraphDef -> SameDiff: not ported yet (it builds a SameDiff)."""

    @staticmethod
    def import_graph(source):
        raise NotImplementedError(
            "TFGraphMapper (TF GraphDef import into SameDiff) is not "
            "ported yet (ROADMAP.md queue A, item 15: it needs "
            "autodiff/samediff)")


__all__ = ["KerasModelImport", "TFGraphMapper"]
