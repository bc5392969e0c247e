"""Serving runtime of the port: the continuous-batching generation
engine on the slot KV cache or the paged block pool, with the fault
ladder (retry, recompute-recovery, poison, stall watchdog), request
tracing (``generate``/``stream`` take a :class:`~..tracing.Trace`) and
the Prometheus text of its ``stats()`` (:func:`prometheus_text`). The
HTTP shell (InferenceServer with ``/metrics`` and ``/debug/traces``,
registry, asyncio front-end, fleet) comes with a later slice
(ROADMAP.md queue A, items 9b and 9c)."""
from .batcher import DeadlineExceededError, DrainingError, QueueFullError
from .engine import ClientError, ServingError
from .faults import (CorruptedStateFault, FaultInjector, PoisonRequestError,
                     TransientFault)
from .generation import GenerationEngine
from .kvcache import KVCache, SlotTable
from .metrics import GenerationMetrics, profiler_sections, prometheus_text
from .paging import BlockAllocator, BlockTable, PagedKVCache

__all__ = ["BlockAllocator", "BlockTable", "ClientError",
           "CorruptedStateFault", "DeadlineExceededError", "DrainingError",
           "FaultInjector", "GenerationEngine", "GenerationMetrics",
           "KVCache", "PagedKVCache", "PoisonRequestError", "QueueFullError",
           "ServingError", "SlotTable", "TransientFault", "profiler_sections",
           "prometheus_text"]
