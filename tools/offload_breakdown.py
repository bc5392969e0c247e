"""Where the scheduler thread's time goes in chip_smoke.py's phase 14
(the KV tier at f32): host timers around the engine's demote and
restore steps (the gather's export with its D2H copy and sync, the
host copies, the store's put with its spills to the disk ring, the
restore's import), summed over the phase and printed as one
"BREAKDOWN" JSON line with the card's name and power limit.

    python3 tools/offload_breakdown.py      # on a CUDA card
"""
import collections
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (owner, attribute, label) of each timed step
STEPS = (("engine", "_export_run", "export_run (gather, D2H, sync, pack)"),
         ("engine", "_sync", "sync (all callers)"),
         ("generation", "kv_pack_host", "kv_pack_host"),
         ("store", "put", "store.put (spills inside)"),
         ("run", "pack", "HostRun.pack (spill)"),
         ("ring", "put", "DiskRing.put (spill)"),
         ("ring", "get", "DiskRing.get (inline disk read)"),
         ("engine", "_import_run", "import_run (H2D, scatter, sync)"),
         ("engine", "_build_restore_ops", "build_restore_ops (inline)"),
         ("engine", "_demote_session", "demote_session"),
         ("engine", "_demote_prefix", "demote_prefix"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("offload_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.kernels import _build
    from deeplearning4j_tpu_torch.serving import generation, offload
    _build.build()
    owners = {"engine": generation.GenerationEngine,
              "generation": generation, "store": offload.HostBlockStore,
              "run": offload.HostRun, "ring": offload.DiskRing}
    total = collections.defaultdict(float)
    calls = collections.Counter()

    def timed(owner, name, label):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if threading.current_thread().name == \
                        "generation-scheduler":
                    total[label] += (time.perf_counter() - t0) * 1e3
                    calls[label] += 1
        setattr(owner, name, wrapped)

    for owner, name, label in STEPS:
        timed(owners[owner], name, label)
    card = cs.card_line()
    t0 = time.perf_counter()
    cs.serve_offload(card, "f32")
    print("BREAKDOWN " + json.dumps(dict(
        card=card, phase_s=time.perf_counter() - t0, ms=dict(total),
        calls=dict(calls))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
