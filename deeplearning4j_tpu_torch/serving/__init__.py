"""Serving runtime of the port: the continuous-batching generation
engine on the slot KV cache or the paged block pool. The HTTP shell
(InferenceServer, registry, asyncio front-end, fleet) comes with a later
slice (ROADMAP.md queue A, item 9)."""
from .batcher import DeadlineExceededError, DrainingError, QueueFullError
from .engine import ClientError, ServingError
from .generation import GenerationEngine
from .kvcache import KVCache, SlotTable
from .metrics import GenerationMetrics
from .paging import BlockAllocator, BlockTable, PagedKVCache

__all__ = ["BlockAllocator", "BlockTable", "ClientError",
           "DeadlineExceededError", "DrainingError", "GenerationEngine",
           "GenerationMetrics", "KVCache", "PagedKVCache", "QueueFullError",
           "ServingError", "SlotTable"]
