"""Request serving over the KV-cached decode path (continuous batching)."""

from bigdl_tpu_torch.serving.engine import (
    EngineShutdown, NonFiniteLogitsError, ServingEngine,
)
from bigdl_tpu_torch.serving.request import (
    CompletedRequest, Request, RequestHandle,
)
from bigdl_tpu_torch.serving.scheduler import (
    SlotScheduler, default_buckets, pick_bucket,
)

__all__ = [
    "CompletedRequest", "EngineShutdown", "NonFiniteLogitsError", "Request",
    "RequestHandle", "ServingEngine", "SlotScheduler", "default_buckets",
    "pick_bucket",
]
