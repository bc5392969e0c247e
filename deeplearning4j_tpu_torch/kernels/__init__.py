"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module (``decode_attention``, ``paged_attention``,
``flash_attention``) holds
the wrapper that launches its CUDA source from ``csrc/`` on CUDA
tensors, the plain PyTorch version that CPU tensors take, and a
``launches`` counter. CUDA sources are built and loaded only when a
kernel first runs, so importing these modules needs no CUDA toolkit.
"""

#: each kernel module's launch counters
_COUNTERS = (("decode_attention", ("launches", "launches_int8")),
             ("paged_attention", ("launches", "launches_int8")),
             ("flash_attention", ("launches", "launches_dq", "launches_dkv",
                                  "launches_bf16", "launches_dq_bf16",
                                  "launches_dkv_bf16")))


def launch_counts() -> dict:
    """Every kernel's launch counter, keyed ``module.counter``."""
    import importlib
    out = {}
    for mod, names in _COUNTERS:
        m = importlib.import_module(f"{__name__}.{mod}")
        out.update({f"{mod}.{n}": getattr(m, n) for n in names})
    return out


def add_launches(counts: dict) -> None:
    """Add ``counts`` (keyed as :func:`launch_counts` keys them) to the
    counters: a replayed CUDA graph launches its kernels without calling
    their wrappers."""
    import importlib
    for key, n in counts.items():
        mod, name = key.split(".")
        m = importlib.import_module(f"{__name__}.{mod}")
        setattr(m, name, getattr(m, name) + n)
