"""Request serving over the KV-cached decode path (continuous batching),
with the paged KV cache, the prefix pool and speculative decoding; crash
recovery, drain, health and hot weight swaps in the engine; the fleet
router, the snapshot server and the promotion lifecycle around it; the
``RankingEngine`` of the recommenders (``serving/ranking.py``)."""

from bigdl_tpu_torch.serving.engine import (
    EngineOverloaded, EngineShutdown, EngineShutdownTimeout,
    NonFiniteLogitsError, RequestTimeout, ServingEngine, SwapResult,
)
from bigdl_tpu_torch.serving.fleet import (
    FleetExhausted, FleetHandle, FleetRouter,
)
from bigdl_tpu_torch.serving.lifecycle import (
    PromotionController, PromotionCriterion, PromotionResult,
)
from bigdl_tpu_torch.serving.multitenant import SnapshotServer
from bigdl_tpu_torch.serving.paged_cache import (
    TRASH_PAGE, PageAllocator, install_paged_cache, logical_pages,
)
from bigdl_tpu_torch.serving.prefix_cache import PrefixEntry, PrefixPool
from bigdl_tpu_torch.serving.ranking import (
    RankedResult, RankingEngine, RankingHandle,
)
from bigdl_tpu_torch.serving.request import (
    FINISH_EOS, FINISH_LENGTH, CompletedRequest, Request, RequestHandle,
)
from bigdl_tpu_torch.serving.scheduler import (
    SlotScheduler, default_buckets, pick_bucket, pick_seed_bucket,
)
from bigdl_tpu_torch.serving.speculative import SpeculativeDecoder

__all__ = [
    "CompletedRequest", "EngineOverloaded", "EngineShutdown",
    "EngineShutdownTimeout", "FINISH_EOS", "FINISH_LENGTH",
    "FleetExhausted", "FleetHandle", "FleetRouter",
    "NonFiniteLogitsError", "PageAllocator", "PrefixEntry", "PrefixPool",
    "PromotionController", "PromotionCriterion", "PromotionResult",
    "RankedResult", "RankingEngine", "RankingHandle",
    "Request", "RequestHandle", "RequestTimeout", "ServingEngine",
    "SlotScheduler", "SnapshotServer", "SpeculativeDecoder", "SwapResult",
    "TRASH_PAGE", "default_buckets", "install_paged_cache",
    "logical_pages", "pick_bucket", "pick_seed_bucket",
]
