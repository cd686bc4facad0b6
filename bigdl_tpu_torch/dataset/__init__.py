"""Host data path of the port, named as in ``bigdl_tpu.dataset``."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet, TransformedDataSet,
)
from bigdl_tpu_torch.dataset.parallel import (
    ParallelTransformer, data_workers, plan_stages,
)
from bigdl_tpu_torch.dataset.prefetch import PrefetchingFeed
from bigdl_tpu_torch.dataset.profiling import feed_stats, stage_deltas_ms
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.text import (
    Dictionary, LabeledSentenceToSample, SentenceTokenizer,
    TextToLabeledSentence, load_ptb, ptb_windows, synthetic_ptb,
)
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, FusedTransformer, Identity, MapTransformer,
    Transformer, fuse_chain,
)

__all__ = [
    "AbstractDataSet", "ChainedTransformer", "DataSet", "Dictionary",
    "FusedTransformer", "Identity", "LabeledSentenceToSample",
    "LocalDataSet", "MapTransformer", "MiniBatch", "ParallelTransformer",
    "PrefetchingFeed", "Sample", "SampleToMiniBatch", "SentenceTokenizer",
    "TextToLabeledSentence", "TransformedDataSet", "Transformer",
    "data_workers", "feed_stats", "fuse_chain", "load_ptb", "plan_stages",
    "ptb_windows", "stage_deltas_ms", "synthetic_ptb",
]
