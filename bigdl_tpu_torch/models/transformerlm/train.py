"""Transformer LM training main of the port, on the synthetic token stream.

Counterpart of ``bigdl_tpu/models/transformerlm/train.py``: builds
``TransformerLM``, slices ``synthetic_ptb`` into windows of ``--seq-len``
tokens, and trains with ``Adam`` through ``LocalOptimizer`` for
``--max-iteration`` steps, then prints the final loss and, with
``--generate N``, beam-decodes N tokens from a seed. Runs on the card
unless ``--device cpu``; ``BIGDL_COMPUTE_DTYPE=bf16`` trains in bf16 mixed
precision (``utils/engine.py``), and ``BIGDL_FUSE_STEPS=K`` runs K steps a
window (``LocalOptimizer.set_fuse_steps``, read by the optimizer, as in
JAX)::

    python -m bigdl_tpu_torch.models.transformerlm.train -b 16 --seq-len 512
    python -m bigdl_tpu_torch.models.transformerlm.train --rope \\
        --num-kv-heads 2 --norm rms --mlp swiglu --fused-head
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bigdl_tpu_torch.models.unported import refuse_unported

#: flags of the JAX main that this port does not take yet, and the
#: ROADMAP item that brings each
UNPORTED_FLAGS = {
    "--folder": "Queue A.5 (text corpus: Dictionary, SentenceTokenizer)",
    "--model-snapshot": "Queue A.6 (module save/load)",
    "--save": "Queue A.6 (module save/load)",
    "--lora": "Queue A.5 (nn/lora.py)",
    "--distributed": "Queue A.6 (DistriOptimizer)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transformer LM training "
                                            "(PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--rope", action="store_true",
                   help="rotary position embeddings instead of the learned "
                        "table")
    p.add_argument("--num-kv-heads", type=int, default=None,
                   help="grouped-query attention: KV heads shared across "
                        "query-head groups (1 = multi-query)")
    p.add_argument("--norm", default="layer", choices=["layer", "rms"])
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--fused-head", action="store_true",
                   help="FusedLMHead + chunked softmax cross-entropy (the "
                        "logits are never materialized in training)")
    p.add_argument("--max-iteration", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--synthetic-tokens", type=int, default=200_000)
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, beam-decode N tokens from a seed")
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def main(argv=None) -> float:
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv, UNPORTED_FLAGS)
    args = build_parser().parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(0)
    model = TransformerLM(args.vocab_size, args.embed_dim, args.num_heads,
                          args.num_layers, max_len=args.seq_len,
                          dropout=args.dropout, remat=args.remat,
                          fused_head=args.fused_head,
                          num_kv_heads=args.num_kv_heads,
                          position="rope" if args.rope else "learned",
                          norm=args.norm, mlp_kind=args.mlp,
                          generator=torch.Generator().manual_seed(0),
                          device=args.device)
    ids = synthetic_ptb(args.synthetic_tokens, vocab_size=args.vocab_size)
    xs, ys = ptb_windows(ids, args.seq_len)
    data = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(args.batch_size))
    opt = (LocalOptimizer(model, data,
                          lm_criterion(fused_head=args.fused_head),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_iteration(args.max_iteration)))
    opt.optimize()
    print(f"final loss: {opt.state['loss']:.4f}")
    if args.generate:
        # a rope model has no position table to outgrow; only the learned
        # table bounds the total length
        if not args.rope and \
                args.generate + args.seq_len // 4 > args.seq_len:
            raise SystemExit("--generate must fit in --seq-len (the model's "
                             "max_len) together with the seed prefix")
        seed = np.asarray(xs[0][: args.seq_len // 4])[None]
        bs = nn.SequenceBeamSearch(model, beam_size=args.beam, eos_id=-1,
                                   decode_length=args.generate, alpha=0.6)
        out = bs.forward(seed)
        print("generated ids:", out[1][0, 0].tolist())
    return opt.state["loss"]


if __name__ == "__main__":
    main()
