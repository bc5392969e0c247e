"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module (``decode_attention``, ``paged_attention``,
``flash_attention``) holds
the wrapper that launches its CUDA source from ``csrc/`` on CUDA
tensors, the plain PyTorch version that CPU tensors take, and a
``launches`` counter. CUDA sources are built and loaded only when a
kernel first runs, so importing these modules needs no CUDA toolkit.
"""
