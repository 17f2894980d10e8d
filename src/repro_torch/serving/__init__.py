"""Serving on the port: paged KV cache, mode-batching scheduler, engine."""
from repro_torch.serving.engine import Request, RetryPolicy, ServeEngine
from repro_torch.serving.kv_cache import (BlockAllocator, CacheConfig,
                                          PagedKVCache)
from repro_torch.serving.scheduler import (ModeScheduler, SchedulerConfig,
                                           TickPlan)

__all__ = ["BlockAllocator", "CacheConfig", "ModeScheduler", "PagedKVCache",
           "Request", "RetryPolicy", "SchedulerConfig", "ServeEngine",
           "TickPlan"]
