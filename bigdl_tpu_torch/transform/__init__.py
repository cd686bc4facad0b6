"""Transformers of the port, named as in ``bigdl_tpu.transform``."""
