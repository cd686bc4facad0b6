from bigdl_tpu_torch.models.rnn.rnn import PTBModel, SimpleRNN

__all__ = ["PTBModel", "SimpleRNN"]
