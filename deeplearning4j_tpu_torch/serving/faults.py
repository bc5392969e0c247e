"""Re-export of the port's fault toolkit (:mod:`deeplearning4j_tpu_torch.faults`)
for serving code, as ``deeplearning4j_tpu/serving/faults.py`` re-exports
the JAX package's: the classes are the shared ones, so ``isinstance``
checks and ``except`` clauses match across serving and training."""
from __future__ import annotations

from ..faults import (SEAMS, CorruptedStateFault, FaultError,  # noqa: F401
                      FaultInjector, PoisonRequestError, PreemptionFault,
                      TransientFault, poll_until_idle)

__all__ = ["SEAMS", "CorruptedStateFault", "FaultError", "FaultInjector",
           "PoisonRequestError", "PreemptionFault", "TransientFault",
           "poll_until_idle"]
