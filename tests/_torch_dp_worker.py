"""One rank of the port's data-parallel CPU tests (started by
``tests/_torch_dp_util.run_ranks``)::

    python tests/_torch_dp_worker.py SCENARIO ADDR WORLD RANK OUTDIR

joins a gloo world of WORLD ranks at ADDR through the port's
``initialize_cluster``, runs ``tests/_torch_dp_scenarios.SCENARIO(rank,
world, outdir)`` with one torch thread, and checks that neither JAX nor
the JAX package was imported on the way."""
import os
import sys


def main() -> int:
    scenario, addr, world, rank, outdir = sys.argv[1:6]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel.elastic import initialize_cluster
    assert initialize_cluster(addr, int(world), int(rank))
    import _torch_dp_scenarios as S
    getattr(S, scenario)(int(rank), int(world), outdir)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    if leaked:
        raise AssertionError(f"a rank imported {leaked[:5]}")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
