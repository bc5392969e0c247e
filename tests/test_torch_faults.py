"""The port's FaultInjector (``deeplearning4j_tpu_torch/faults.py``)
against the JAX package's: the cases of the JAX ``TestFaultInjector``
(exact plan indices, seed-deterministic rate streams, per-seam
independence, corrupting seams, the returning and sleeping seams,
configuration errors), and the same seed, rates, plan and worker firing
the same sequence in both packages."""
import time

import pytest

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu_torch.faults import (SEAMS, CorruptedStateFault,
                                             FaultInjector, PreemptionFault,
                                             TransientFault)
from deeplearning4j_tpu_torch.serving import faults as serving_faults


def test_plan_fires_exact_indices():
    inj = FaultInjector(plan={"device_step": [2, 4]})
    fired = []
    for _ in range(5):
        try:
            inj.fire("device_step")
            fired.append(False)
        except TransientFault:
            fired.append(True)
    assert fired == [False, True, False, True, False]
    snap = inj.snapshot()
    assert snap["calls"]["device_step"] == 5
    assert snap["fired"]["device_step"] == 2


def test_rate_stream_is_seed_deterministic():
    def pattern(seed):
        inj = FaultInjector(seed=seed, rates={"prefill": 0.3})
        out = []
        for _ in range(50):
            try:
                inj.fire("prefill")
                out.append(0)
            except TransientFault:
                out.append(1)
        return out
    assert pattern(7) == pattern(7)
    assert sum(pattern(7)) > 0  # actually fires at 30%


def test_seam_independence():
    """Calls at another seam must not shift a seam's decision stream
    (per-seam counters and per-seam random streams)."""
    def pattern(interleave):
        inj = FaultInjector(seed=3, rates={"device_step": 0.5})
        out = []
        for _ in range(30):
            if interleave:
                inj.fire("client_disconnect")  # separate stream
            try:
                inj.fire("device_step")
                out.append(0)
            except TransientFault:
                out.append(1)
        return out
    assert pattern(False) == pattern(True)


def test_corrupting_seam_raises_corrupted():
    inj = FaultInjector(plan={"device_step": [1]},
                        corrupting=("device_step",))
    with pytest.raises(CorruptedStateFault):
        inj.fire("device_step")


def test_client_disconnect_returns_instead_of_raising():
    inj = FaultInjector(plan={"client_disconnect": [1]})
    assert inj.fire("client_disconnect") is True
    assert inj.fire("client_disconnect") is False


def test_latency_seam_sleeps():
    inj = FaultInjector(plan={"latency": [1]}, latency_ms=30.0)
    t0 = time.perf_counter()
    assert inj.fire("latency") is True
    assert time.perf_counter() - t0 >= 0.025


def test_config_validation():
    with pytest.raises(ValueError):
        FaultInjector(rates={"no_such_seam": 0.1})
    with pytest.raises(ValueError):
        FaultInjector(rates={"prefill": 1.5})
    with pytest.raises(ValueError):
        FaultInjector().fire("no_such_seam")


def _fires(inj, exc_types, calls):
    """The outcome of each ``(seam, worker)`` call: the exception's
    class name, or what ``fire`` returned."""
    out = []
    for seam, worker in calls:
        try:
            out.append(inj.fire(seam, worker=worker))
        except exc_types as e:
            out.append(type(e).__name__)
    return out


def test_same_plan_fires_the_same_calls_as_jax():
    """One seed, rates, plan (flat and per worker), corrupting set and
    worker give the same outcome at every call in both packages, so a
    chaos plan means the same faults on either engine."""
    assert SEAMS == jfaults.SEAMS
    kw = dict(seed=29,
              rates={"device_step": 0.2, "prefill": 0.1, "alloc": 0.3,
                     "client_disconnect": 0.05, "train_step": 0.25},
              plan={"device_step": [3, 7], "alloc": [1],
                    "preempt": {1: [2], 2: [5]}},
              corrupting=("prefill",), latency_ms=0.0)
    calls = [(s, w) for _ in range(40)
             for s in ("device_step", "prefill", "alloc",
                       "client_disconnect", "latency")
             for w in (None,)]
    calls += [(s, w) for _ in range(12)
              for s in ("train_step", "preempt") for w in (0, 1, 2)]
    port = FaultInjector(**kw)
    ref = jfaults.FaultInjector(**kw)
    got = _fires(port, (TransientFault, CorruptedStateFault,
                        PreemptionFault), calls)
    want = _fires(ref, (jfaults.TransientFault, jfaults.CorruptedStateFault,
                        jfaults.PreemptionFault), calls)
    assert got == want
    assert {"TransientFault", "CorruptedStateFault", "PreemptionFault",
            True} <= set(got)
    assert port.snapshot() == ref.snapshot()
    # the serving shim re-exports the port's own classes
    assert serving_faults.FaultInjector is FaultInjector
    assert serving_faults.TransientFault is TransientFault
