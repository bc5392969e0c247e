"""Utilities of the port (counterpart of ``deeplearning4j_tpu/util``):
the model serializer."""
