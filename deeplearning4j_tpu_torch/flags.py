"""Central flag / environment-variable registry (the port's copy of
``deeplearning4j_tpu/flags.py``: the same registry, and the same names,
defaults and parsing for the flags the port reads).

Ref: `nd4j/nd4j-common/src/main/java/org/nd4j/config/ND4JSystemProperties.java`
(115 lines) and `ND4JEnvironmentVars.java` (122 lines) — the reference
declares every tunable system property / env var in one place with
javadoc, instead of scattering `System.getenv` calls. Same discipline
here: every environment variable this framework reads is declared below
with a type, default, and description. Modules import :data:`flags`
(the singleton) instead of touching ``os.environ`` directly.

The port declares only the flags it reads: ``data_dir``, ``mnist_dir``
and ``cifar10_dir`` (``datasets/``). Each of the JAX package's other
flags (dtype, kernels, profiling, native runtime, UI, bench) is declared
here when a port module honours it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class Flag:
    """One declared environment variable (ref: the per-constant javadoc
    blocks in ND4JSystemProperties)."""
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str

    def get(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parse(raw)
        except (ValueError, TypeError):
            return self.default


class FlagRegistry:
    """The registry. Attribute access returns the *current* parsed value
    (env re-read each time, like the reference's System.getProperty use),
    so tests can monkeypatch os.environ."""

    def __init__(self):
        self._flags: Dict[str, Flag] = {}

    def declare(self, attr: str, name: str, default: Any,
                parse: Callable[[str], Any], doc: str) -> None:
        self._flags[attr] = Flag(name, default, parse, doc)

    def __getattr__(self, attr: str) -> Any:
        flags = object.__getattribute__(self, "_flags")
        if attr in flags:
            return flags[attr].get()
        raise AttributeError(attr)

    def env_name(self, attr: str) -> str:
        return self._flags[attr].name

    def describe(self) -> str:
        """Human-readable table of every declared flag (ref: the javadoc
        surface of ND4JSystemProperties)."""
        lines = []
        for attr, f in sorted(self._flags.items()):
            cur = f.get()
            lines.append(f"{f.name} (flags.{attr})")
            lines.append(f"    default={f.default!r} current={cur!r}")
            lines.append(f"    {f.doc}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Any]:
        return {attr: f.get() for attr, f in self._flags.items()}


flags = FlagRegistry()

# -- data locations (ref: ND4JSystemProperties.ND4J_RESOURCES_CACHE_DIR) --
flags.declare(
    "data_dir", "DL4J_TPU_DATA_DIR", os.path.expanduser("~/.deeplearning4j_tpu"),
    str, "Root directory for downloaded/cached datasets and fixtures.")
flags.declare(
    "mnist_dir", "MNIST_DATA_DIR", "", str,
    "Directory holding the 4 MNIST idx files (raw or .gz). Empty = probe "
    "standard locations, then fall back to the labeled synthetic set.")
flags.declare(
    "cifar10_dir", "CIFAR10_DATA_DIR", "", str,
    "Directory holding CIFAR-10 binary batches. Empty = probe standard "
    "locations, then fall back to the labeled synthetic set.")
