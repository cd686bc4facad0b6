from bigdl_tpu_torch.models.widedeep.widedeep import WideAndDeep

__all__ = ["WideAndDeep"]
