"""Host utilities of the port: Table, the admission queue, device choice."""

from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["T", "Table"]
