"""What the fleet's router costs phase 4's traffic on the card
(chip_smoke.py phase 17a), and what the fleet's health poll costs it.

One model at the served width (``chip_smoke.SERVE_CFG``) is served by
three warmed ``InferenceServer`` replicas (aio), each with one "lm"
generator in phase 4's configuration (32 slots): one replica alone, and
two behind a ``FleetRouter`` (aio). Phase 4's 32 requests, half of them
streamed, come from a client process (as in phases 16a and 17a) in
turns, each made ``REPS`` times:

- ``single``: straight to the lone replica over HTTP (phase 16a);
- ``fleet``: through the router while the fleet polls both replicas
  every 0.05 s (``/healthz`` and the whole ``/stats``, whose latency
  reservoirs the replica sorts on its event loop), as in phase 17;
- ``fleet_nopoll``: through the router with no poll.

The poll runs on a thread of this script (``ReplicaFleet.poll_now``
every 0.05 s) only during the ``fleet`` turns. For each turn it prints
tokens/s (the client's clock, first request to last answer), TTFT p50
and decode step p50 (the engines' clocks), and CPU time a decode step
of the replicas' event loops, the router's event loop and the whole
process, as one "FLEET" JSON line with the card's name and power limit.
Every turn's tokens must be the first turn's.

    python3 tools/fleet_profile.py      # on a CUDA card
"""
import collections
import contextlib
import json
import os
import resource
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the order of the turns
TURNS = ("single", "fleet", "fleet_nopoll", "fleet_nopoll", "fleet",
         "single")
#: runs of each turn
REPS = 2
#: the fleet's health poll interval (phase 17's)
POLL_S = 0.05


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


@contextlib.contextmanager
def polling(fleet):
    """Poll the fleet every ``POLL_S`` inside the block."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            fleet.poll_now()
            stop.wait(POLL_S)
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fleet_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.serving import (FleetRouter,
                                                  InferenceServer,
                                                  ReplicaFleet)
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    _build.build()
    card = cs.card_line()
    lm = CausalTransformerLM(**cs.SERVE_CFG).init()

    def replica():
        srv = InferenceServer(port=0)
        srv.register_generator("lm", lm, num_slots=32).warmup()
        return srv

    single = replica()
    fleet = ReplicaFleet(poll_interval_s=None)
    for _ in range(2):
        fleet.add(replica())
    router = FleetRouter(fleet)
    _, rport = router.serve()
    fleet.poll_now()
    servers = [single] + [r.server for r in fleet.replicas()]
    engines = [s.registry.get("lm").engine for s in servers]
    clocks = {"replica_loops": [time.pthread_getcpuclockid(
        s._aio._thread.ident) for s in servers],
        "router_loop": [time.pthread_getcpuclockid(
            router._aio._thread.ident)]}
    reqs = cs.slot_traffic()
    turns, first = [], None
    try:
        for label in TURNS:
            port = single.port if label == "single" else rport
            ttft, steps = [], []
            cpu = collections.Counter()
            n = wall = 0
            steps0 = sum(e.metrics.decode_steps for e in engines)
            with contextlib.ExitStack() as stack:
                for e in engines:
                    ttft.append(stack.enter_context(
                        cs.recorded(e.metrics.ttft_ms)))
                    steps.append(stack.enter_context(
                        cs.recorded(e.metrics.decode_step_ms)))
                if label == "fleet":
                    stack.enter_context(polling(fleet))
                for _ in range(REPS):
                    c0 = {k: [time.clock_gettime(c) for c in ids]
                          for k, ids in clocks.items()}
                    p0 = _cpu_s()
                    results, w, _ = cs.generate_over_http(port, "lm", reqs)
                    cpu["process"] += _cpu_s() - p0
                    for k, ids in clocks.items():
                        cpu[k] += sum(time.clock_gettime(c) - a
                                      for c, a in zip(ids, c0[k]))
                    tokens = [r["tokens"] for r in results]
                    first = first or tokens
                    if tokens != first:
                        raise AssertionError(f"{label}: tokens differ from "
                                             f"the first turn's")
                    n += sum(len(t) for t in tokens)
                    wall += w
            nsteps = sum(e.metrics.decode_steps for e in engines) - steps0
            ttft_all = [v for vals in ttft for v in vals]
            step_all = [v for vals in steps for v in vals]
            turns.append(dict(
                turn=label, runs=REPS, tokens=n, wall_s=wall,
                tokens_per_s=n / wall, decode_steps=nsteps,
                ttft_p50_ms=float(np.percentile(ttft_all, 50)),
                step_p50_ms=float(np.percentile(step_all, 50)),
                cpu_ms_per_step={k: v * 1e3 / nsteps
                                 for k, v in cpu.items()}))
            t = turns[-1]
            print(f"{label}: {t['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                  f"{t['ttft_p50_ms']:.2f} ms, step p50 "
                  f"{t['step_p50_ms']:.3f} ms, cpu ms a step "
                  f"{ {k: round(v, 3) for k, v in t['cpu_ms_per_step'].items()} }",
                  flush=True)
    finally:
        router.stop()
        fleet.stop(stop_replicas=True)
        single.stop()
    print("FLEET " + json.dumps(dict(card=card, poll_s=POLL_S, turns=turns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
