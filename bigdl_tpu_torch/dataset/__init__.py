"""Host data path of the port, named as in ``bigdl_tpu.dataset``."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, DistributedDataSet, LocalDataSet,
    TransformedDataSet, is_distributed,
)
from bigdl_tpu_torch.dataset.parallel import (
    ParallelTransformer, data_workers, plan_stages,
)
from bigdl_tpu_torch.dataset.prefetch import PrefetchingFeed
from bigdl_tpu_torch.dataset.profiling import feed_stats, stage_deltas_ms
from bigdl_tpu_torch.dataset.recordio import (
    RecordFileDataSet, RecordIOError, RecordWriter, encode_image_record,
    image_record_decoder, write_image_records, write_records,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.sample_cache import CacheCorruptError, SampleCache
from bigdl_tpu_torch.dataset.streaming import StreamingDataSet
from bigdl_tpu_torch.dataset.text import (
    Dictionary, LabeledSentenceToSample, SentenceTokenizer,
    TextToLabeledSentence, load_ptb, ptb_windows, synthetic_ptb,
)
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, FusedTransformer, Identity, MapTransformer,
    Transformer, flatten_chain, fuse_chain, sample_index_scope,
)

__all__ = [
    "AbstractDataSet", "CacheCorruptError", "ChainedTransformer", "DataSet",
    "DistributedDataSet", "is_distributed",
    "Dictionary", "FusedTransformer", "Identity", "LabeledSentenceToSample",
    "LocalDataSet", "MapTransformer", "MiniBatch", "ParallelTransformer",
    "PrefetchingFeed", "RecordFileDataSet", "RecordIOError", "RecordWriter",
    "Sample", "SampleCache", "SampleToMiniBatch", "SentenceTokenizer",
    "StreamingDataSet", "TextToLabeledSentence", "TransformedDataSet",
    "Transformer", "data_workers", "encode_image_record", "feed_stats",
    "flatten_chain", "fuse_chain", "sample_index_scope", "image_record_decoder", "load_ptb", "plan_stages",
    "ptb_windows", "stage_deltas_ms", "synthetic_ptb", "write_image_records",
    "write_records",
]
