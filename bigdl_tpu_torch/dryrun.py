"""The flagship model's forward, the port's ``entry()``.

Counterpart of ``bigdl_tpu/dryrun.py`` ``entry``: the TransformerLM
family's forward step and example arguments, on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


def entry(device=None):
    """``(forward, (params, tokens))`` on the flagship
    ``TransformerLM(1024, 256, 4, 2, max_len=256)`` in eval mode:
    ``forward(params, tokens)`` runs the model on ``params`` (a dict of
    tensors by parameter path, the JAX ``get_params()`` paths flattened)
    and returns the (4, 256, 1024) log-probs of ``tokens``."""
    from bigdl_tpu_torch.models.transformerlm import TransformerLM

    model = TransformerLM(vocab_size=1024, embed_dim=256, num_heads=4,
                          num_layers=2, max_len=256, dropout=0.0,
                          device=device).evaluate()
    params = {n: p.detach() for n, p in model.named_parameters()}

    def forward(params, tokens):
        return functional_call(model, params, (tokens,))

    tokens = torch.zeros((4, 256), dtype=torch.long,
                         device=next(iter(params.values())).device)
    return forward, (params, tokens)
