"""The port stands alone: importing every module of it loads neither
JAX nor the JAX package, and its entry points run on the card unless
the caller asks for the CPU."""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "deeplearning4j_tpu"
             or m.startswith("deeplearning4j_tpu.") or m == "h5py"
             or m.startswith("h5py."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_in_a_fresh_process():
    """Every module of the port imports in a fresh process without
    loading JAX, the JAX package or ``h5py`` (the card's machine has no
    ``h5py``: Keras files go through ``modelimport/_h5.py``)."""
    # pytest's own process already holds jax, so ask a fresh one
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("serving.generation", "serving.paging", "serving.faults",
                "serving.speculative", "serving.offload",
                "serving.engine", "serving.batcher", "serving.registry",
                "serving.aio", "serving.fleet",
                "faults",
                "kernels.paged_attention", "kernels.kv_quant",
                "nn.layers.attention", "zoo.transformer_lm",
                "nn.multilayer", "nn.conf", "nn.layers.recurrent",
                "nn.precision", "activations", "losses", "learning",
                "datasets", "convert",
                # the CNN training core
                "nn.layers", "nn.conf.dropout", "learning.schedules",
                "weightinit", "random", "eval", "optimize", "zoo",
                "zoo.simple",
                # checkpoints, the recurrent stack and early stopping
                "util", "util.serializer", "nn.conf.weightnoise",
                "nn.conf.constraint", "earlystopping",
                # transfer learning and resilient training
                "nn.transferlearning", "parallel.resilience",
                "parallel.elastic", "parallel.multihost",
                "parallel.telemetry", "profiler",
                # the rest of nn/layers but SameDiff
                "nn.layers.misc", "nn.layers.variational",
                "nn.layers.specialized_outputs", "nn.layers.objdetect",
                # data-parallel training
                "parallel", "parallel.transport", "parallel.compression",
                "nn.global_batch",
                # Keras import over the port's own HDF5 reader
                "modelimport", "modelimport._h5", "modelimport.keras",
                "flags"):
        assert f"deeplearning4j_tpu_torch.{mod}" in res["imported"], mod
    assert res["bad"] == []


def test_fleet_tier_is_the_ports_own():
    """The router half of ``serving/aio.py`` and ``serving/fleet.py``
    are the port's lifted copies, not the JAX package's."""
    from deeplearning4j_tpu_torch.serving import aio, fleet
    for cls in (aio.AioRouterFrontend, aio._AioUpstream, aio._AioConnPool,
                fleet.FleetRouter, fleet.ReplicaFleet, fleet.Replica,
                fleet.FleetMetrics, fleet._FleetStream, fleet._ConnPool):
        assert cls.__module__.startswith("deeplearning4j_tpu_torch."), cls


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|deeplearning4j_tpu|"
                     r"h5py)(\.|\s|$)", re.M)
    files = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_every_cuda_source_has_a_wrapper_module():
    """Each csrc/*.cu is launched by kernels/<name>.py, which keeps a
    launch counter and a plain version beside it."""
    import importlib
    srcs = sorted(p.stem for p in
                  (REPO / "deeplearning4j_tpu_torch" / "csrc").glob("*.cu"))
    assert srcs == ["decode_attention", "flash_attention",
                    "paged_attention"]
    for name in srcs:
        mod = importlib.import_module(f"deeplearning4j_tpu_torch.kernels."
                                      f"{name}")
        assert isinstance(mod.launches, int)
        assert callable(getattr(mod, f"{name}_torch"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        CausalTransformerLM(vocab_size=16, d_model=8, n_layers=1,
                            n_heads=2, max_seq_len=8)
    lm = CausalTransformerLM(vocab_size=16, d_model=8, n_layers=1,
                             n_heads=2, max_seq_len=8, device="cpu")
    assert lm.device.type == "cpu"
