"""Host data path of the port (numpy only), named as in
``bigdl_tpu.dataset``."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, LocalDataSet, TransformedDataSet,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.text import ptb_windows, synthetic_ptb
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer, Identity, MapTransformer, Transformer,
)

__all__ = [
    "AbstractDataSet", "ChainedTransformer", "DataSet", "Identity",
    "LocalDataSet", "MapTransformer", "MiniBatch", "Sample",
    "SampleToMiniBatch", "TransformedDataSet", "Transformer", "ptb_windows",
    "synthetic_ptb",
]
