"""Where the generation engine's scheduler thread spends a decode step
when phase 4's traffic comes over HTTP (chip_smoke.py phase 16a) and
when it comes from threads calling the engine directly.

One warmed slot engine at the served width (``chip_smoke.SERVE_CFG``,
32 slots) behind ``InferenceServer`` (aio backend) serves phase 4's 32
requests in turns, each made ``REPS`` times: direct (every request
from its own thread, through ``generate`` or, all streamed, through
``stream``), over HTTP with none, half or all of them streamed, and two
HTTP turns again at a
0.5 ms interpreter switch interval (``sys.setswitchinterval``; the
default is 5 ms). For each turn it prints tokens/s (over HTTP, on the
client process's clock from its first request to its last answer, as
phase 16a), the decode step's p50 and its event wait's p50 (the
engine's own clocks), the scheduler thread's CPU time a step (its
thread CPU clock, whose resolution is printed too), the event loop
thread's, the whole server process's and the HTTP client process's
CPU time a step (``getrusage``), and wall and CPU
time a step inside the loop's parts (admit, which holds the idle wait
for requests; dispatch; collect with the event wait, the per-token
emit inside collect, the stream push of items queued outside a decode
step, and the notify of a step's streams at its end), as one "LOOP"
JSON line with the card's name and power limit.

A step whose wall time grows while its CPU time does not waits: for
the device, or for the interpreter lock after the event wait released
it. A step whose CPU time grows does more host work a token.

    python3 tools/http_loop_profile.py      # on a CUDA card
"""
import collections
import json
import os
import resource
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (owner, attribute, label) of each timed part of the scheduler loop
PARTS = (("engine", "_admit", "admit"),
         ("engine", "_dispatch_decode", "dispatch"),
         ("engine", "_collect_decode", "collect"),
         ("event", "synchronize", "event_wait"),
         ("engine", "_emit", "emit"),
         ("request", "_stream_push", "stream_push"),
         ("engine", "_notify_deferred", "notify"))

#: (label, how the requests arrive, streamed every n-th (0: none), the
#: interpreter's switch interval in seconds)
TURNS = (("direct", "engine", 0, 0.005),
         ("direct_streamed", "engine", 1, 0.005),
         ("http_none", "http", 0, 0.005),
         ("http_half", "http", 2, 0.005),
         ("http_all", "http", 1, 0.005),
         ("http_half_si0.5ms", "http", 2, 0.0005),
         ("http_all_si0.5ms", "http", 1, 0.0005),
         ("direct_again", "engine", 0, 0.005))
#: runs of each turn (the thread CPU clock may tick in 10 ms)
REPS = 3


def _rusage_s(who: str) -> float:
    """User + system CPU seconds of this process ("self") or of its
    waited-for children ("children": the HTTP client processes)."""
    r = resource.getrusage(resource.RUSAGE_SELF if who == "self"
                           else resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime


def _p50(xs):
    import numpy as np
    return float(np.percentile(xs, 50)) if xs else None


def stream_requests(eng, reqs):
    """Every request at once from its own thread through the engine's
    ``stream``; returns ({"tokens"} in ``reqs``'s order, wall seconds)."""
    results = [None] * len(reqs)

    def go(i):
        results[i] = {"tokens": [item["token"] for item in eng.stream(
            timeout_ms=600_000, **reqs[i]) if "token" in item]}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if any(r is None for r in results):
        raise RuntimeError("a streamed request failed")
    return results, wall


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("http_loop_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.serving import InferenceServer, generation
    from deeplearning4j_tpu_torch.zoo.transformer_lm import \
        CausalTransformerLM
    _build.build()
    owners = {"engine": generation.GenerationEngine,
              "event": torch.cuda.Event, "request": generation._GenRequest}
    wall = collections.defaultdict(float)
    cpu = collections.defaultdict(float)
    calls = collections.Counter()

    def timed(owner, name, label):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            if threading.current_thread().name != "generation-scheduler":
                return fn(*a, **k)
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **k)
            finally:
                wall[label] += (time.perf_counter() - t0) * 1e3
                cpu[label] += (time.thread_time() - c0) * 1e3
                calls[label] += 1
        setattr(owner, name, wrapped)

    for owner, name, label in PARTS:
        if hasattr(owners[owner], name):   # older checkouts lack some
            timed(owners[owner], name, label)
    card = cs.card_line()
    lm = CausalTransformerLM(**cs.SERVE_CFG).init()
    srv = InferenceServer(port=0)
    turns, resolution_s = [], None
    try:
        gen = srv.register_generator("lm", lm, num_slots=32)
        gen.warmup()
        eng = gen.engine
        sched = eng._thread
        clock = time.pthread_getcpuclockid(sched.ident)
        loop_clock = time.pthread_getcpuclockid(srv._aio._thread.ident)
        resolution_s = time.clock_getres(clock)
        steps_ms, waits_ms = [], []
        for res, out in ((eng.metrics.decode_step_ms, steps_ms),
                         (eng.metrics.decode_sync_wait_ms, waits_ms)):
            record = res.record

            def kept(v, record=record, out=out):
                out.append(float(v))
                record(v)
            res.record = kept
        reqs = cs.slot_traffic()
        first = None
        for label, how, every, interval in TURNS:
            wall.clear()
            cpu.clear()
            calls.clear()
            steps_ms.clear()
            waits_ms.clear()
            old = sys.getswitchinterval()
            sys.setswitchinterval(interval)
            n, busy_s, c_s, steps = 0, 0.0, 0.0, 0
            other = collections.Counter()
            try:
                for _ in range(REPS):
                    steps0 = eng.metrics.decode_steps
                    u0 = (time.clock_gettime(loop_clock), _rusage_s("self"),
                          _rusage_s("children"))
                    c0 = time.clock_gettime(clock)
                    if how == "engine":
                        results, wall_s = (stream_requests if every
                                           else cs.run_requests)(eng, reqs)
                    else:
                        results, wall_s, _ = cs.generate_over_http(
                            srv.port, "lm", reqs, every)
                    c_s += time.clock_gettime(clock) - c0
                    for key, a, b in zip(
                            ("loop", "process", "client"), u0,
                            (time.clock_gettime(loop_clock),
                             _rusage_s("self"), _rusage_s("children"))):
                        other[key] += b - a
                    steps += eng.metrics.decode_steps - steps0
                    tokens = [r["tokens"] for r in results]
                    first = first or tokens
                    n += sum(len(t) for t in tokens)
                    busy_s += wall_s
            finally:
                sys.setswitchinterval(old)
            turns.append(dict(
                turn=label, switch_interval_ms=interval * 1e3,
                runs=REPS, tokens=n, wall_s=busy_s,
                tokens_per_s=n / busy_s, decode_steps=steps,
                step_p50_ms=_p50(steps_ms),
                event_wait_p50_ms=_p50(waits_ms),
                loop_cpu_ms_per_step=c_s * 1e3 / steps,
                event_loop_cpu_ms_per_step=other["loop"] * 1e3 / steps,
                process_cpu_ms_per_step=other["process"] * 1e3 / steps,
                client_cpu_ms_per_step=other["client"] * 1e3 / steps,
                parts_wall_ms_per_step={k: v / steps
                                        for k, v in wall.items()},
                parts_cpu_ms_per_step={k: v / steps
                                       for k, v in cpu.items()},
                calls=dict(calls),
                lanes_differing_from_first_run=sum(
                    a != b for a, b in zip(tokens, first))))
            t = turns[-1]
            print(f"{label}: {n / busy_s:.1f} tokens/s, step p50 "
                  f"{t['step_p50_ms']:.3f} ms, cpu ms a step: scheduler "
                  f"{t['loop_cpu_ms_per_step']:.3f}, event loop "
                  f"{t['event_loop_cpu_ms_per_step']:.3f}, process "
                  f"{t['process_cpu_ms_per_step']:.3f}, client "
                  f"{t['client_cpu_ms_per_step']:.3f}", flush=True)
    finally:
        srv.stop()
    print("LOOP " + json.dumps(dict(
        card=card, thread_clock_resolution_s=resolution_s,
        turns=turns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
