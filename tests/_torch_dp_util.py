"""Spawning the port's data-parallel CPU test ranks: ``world`` processes
of ``tests/_torch_dp_worker.py``, each a gloo rank on the CPU with one
torch thread, running one scenario function of
``tests/_torch_dp_scenarios.py``. The spawn has a deadline; a rank that
fails ends the spawn at once, and every rank still running at the end
is killed. Each rank's output goes to a log file beside its results."""
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dp_worker.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(scenario: str, world: int, outdir: str,
              timeout: float = 120.0):
    """Run ``scenario`` (a function name of the scenarios module) on
    ``world`` ranks writing into ``outdir``; raise with the ranks' logs
    when one fails or the deadline passes."""
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=ROOT)
    logs = [os.path.join(outdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, scenario, addr, str(world),
                 str(r), outdir], stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failed = "a rank failed"
                break
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
        else:
            failed = f"the ranks outlasted {timeout:.0f} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for r, path in enumerate(logs):
        with open(path) as f:
            text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                        + f.read()[-4000:])
    raise AssertionError(f"{scenario}: {failed}\n" + "\n".join(text))
