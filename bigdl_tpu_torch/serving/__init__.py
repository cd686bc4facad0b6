"""Request serving over the KV-cached decode path (continuous batching),
with the paged KV cache, the prefix pool and speculative decoding."""

from bigdl_tpu_torch.serving.engine import (
    EngineOverloaded, EngineShutdown, NonFiniteLogitsError, RequestTimeout,
    ServingEngine,
)
from bigdl_tpu_torch.serving.paged_cache import (
    TRASH_PAGE, PageAllocator, install_paged_cache, logical_pages,
)
from bigdl_tpu_torch.serving.prefix_cache import PrefixPool
from bigdl_tpu_torch.serving.request import (
    CompletedRequest, Request, RequestHandle,
)
from bigdl_tpu_torch.serving.scheduler import (
    SlotScheduler, default_buckets, pick_bucket, pick_seed_bucket,
)
from bigdl_tpu_torch.serving.speculative import SpeculativeDecoder

__all__ = [
    "CompletedRequest", "EngineOverloaded", "EngineShutdown",
    "NonFiniteLogitsError", "PageAllocator", "PrefixPool", "Request",
    "RequestHandle", "RequestTimeout", "ServingEngine", "SlotScheduler",
    "SpeculativeDecoder", "TRASH_PAGE", "default_buckets",
    "install_paged_cache", "logical_pages", "pick_bucket",
    "pick_seed_bucket",
]
