"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module (``decode_attention``, ``paged_attention``,
``flash_attention``) holds
the wrapper that launches its CUDA source from ``csrc/`` on CUDA
tensors, the plain PyTorch version that CPU tensors take, and a
``launches`` counter. CUDA sources are built and loaded only when a
kernel first runs, so importing these modules needs no CUDA toolkit.
"""
import contextlib
import importlib
import threading

#: each kernel module's launch counters
_COUNTERS = (("decode_attention", ("launches", "launches_int8")),
             ("paged_attention", ("launches", "launches_int8")),
             ("flash_attention", ("launches", "launches_dq", "launches_dkv",
                                  "launches_bf16", "launches_dq_bf16",
                                  "launches_dkv_bf16")))


#: guards the counters: wrappers and graph replays count from several
#: threads (a server's batcher, a generation engine's loop)
_LOCK = threading.Lock()
#: ``counts``: the tally of the capture under way on this thread
_CAPTURE = threading.local()


def launch_counts() -> dict:
    """Every kernel's launch counter, keyed ``module.counter``."""
    out = {}
    with _LOCK:
        for mod, names in _COUNTERS:
            m = importlib.import_module(f"{__name__}.{mod}")
            out.update({f"{mod}.{n}": getattr(m, n) for n in names})
    return out


def add_launches(counts: dict) -> None:
    """Add ``counts`` (keyed as :func:`launch_counts` keys them) to the
    counters: a replayed CUDA graph launches its kernels without calling
    their wrappers."""
    with _LOCK:
        for key, n in counts.items():
            mod, name = key.split(".")
            m = importlib.import_module(f"{__name__}.{mod}")
            setattr(m, name, getattr(m, name) + n)


def count_launch(key: str) -> None:
    """One launch by a wrapper, keyed ``module.counter``. While this
    thread captures a CUDA graph (:func:`tally_launches`) the launch
    goes to the capture's tally instead: a capture launches nothing,
    and each replay adds the tally. Other threads' launches meanwhile
    count as launches."""
    tally = getattr(_CAPTURE, "counts", None)
    if tally is None:
        add_launches({key: 1})
    else:
        tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def tally_launches():
    """Within the block, this thread's wrapper launches are tallied into
    the dict it yields, not counted (a CUDA graph's capture)."""
    prev = getattr(_CAPTURE, "counts", None)
    _CAPTURE.counts = tally = {}
    try:
        yield tally
    finally:
        _CAPTURE.counts = prev
