"""Serving runtime of the port: the continuous-batching generation
engine on the slot KV cache or the paged block pool, with the fault
ladder (retry, recompute-recovery, poison, stall watchdog). The HTTP
shell (InferenceServer, registry, asyncio front-end, fleet) comes with a
later slice (ROADMAP.md queue A, item 9)."""
from .batcher import DeadlineExceededError, DrainingError, QueueFullError
from .engine import ClientError, ServingError
from .faults import (CorruptedStateFault, FaultInjector, PoisonRequestError,
                     TransientFault)
from .generation import GenerationEngine
from .kvcache import KVCache, SlotTable
from .metrics import GenerationMetrics
from .paging import BlockAllocator, BlockTable, PagedKVCache

__all__ = ["BlockAllocator", "BlockTable", "ClientError",
           "CorruptedStateFault", "DeadlineExceededError", "DrainingError",
           "FaultInjector", "GenerationEngine", "GenerationMetrics",
           "KVCache", "PagedKVCache", "PoisonRequestError", "QueueFullError",
           "ServingError", "SlotTable", "TransientFault"]
