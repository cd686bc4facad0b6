"""Transformer LM training main of the port, on the synthetic token stream.

Counterpart of ``bigdl_tpu/models/transformerlm/train.py``: builds
``TransformerLM``, slices ``synthetic_ptb`` into windows of ``--seq-len``
tokens, and trains with ``Adam`` through ``LocalOptimizer`` for
``--max-iteration`` steps, then prints the final loss. Runs on the card
unless ``--device cpu``; ``BIGDL_COMPUTE_DTYPE=bf16`` trains in bf16 mixed
precision (``utils/engine.py``), and ``BIGDL_FUSE_STEPS=K`` runs K steps a
window (``LocalOptimizer.set_fuse_steps``, read by the optimizer, as in
JAX)::

    python -m bigdl_tpu_torch.models.transformerlm.train -b 16 --seq-len 512
"""

from __future__ import annotations

import argparse
import sys

import torch

#: flags of the JAX main that this port does not take yet, and the
#: ROADMAP item that brings each
UNPORTED_FLAGS = {
    "--folder": "Queue A.5 (text corpus: Dictionary, SentenceTokenizer)",
    "--dropout": "Queue A.2 (Dropout)",
    "--model-snapshot": "Queue A.6 (module save/load)",
    "--save": "Queue A.6 (module save/load)",
    "--lora": "Queue A.5 (nn/lora.py)",
    "--rope": "Queue A.2 (position=rope)",
    "--num-kv-heads": "Queue A.2 (grouped-query attention)",
    "--norm": "Queue A.2 (RMSNorm)",
    "--mlp": "Queue A.2 (swiglu MLP)",
    "--fused-head": "Queue A.2 (FusedLMHead)",
    "--distributed": "Queue A.6 (DistriOptimizer)",
    "--generate": "Queue A.2 (SequenceBeamSearch)",
    "--beam": "Queue A.2 (SequenceBeamSearch)",
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
    p.add_argument("--max-iteration", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--synthetic-tokens", type=int, default=200_000)
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def _refuse_unported(argv) -> None:
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag == "-f":
            flag = "--folder"
        if flag in UNPORTED_FLAGS:
            raise SystemExit(f"{flag} is not supported by the PyTorch port "
                             f"yet: ROADMAP {UNPORTED_FLAGS[flag]}")


def main(argv=None) -> float:
    argv = sys.argv[1:] if argv is None else list(argv)
    _refuse_unported(argv)
    args = build_parser().parse_args(argv)

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
                          remat=args.remat,
                          generator=torch.Generator().manual_seed(0),
                          device=args.device)
    ids = synthetic_ptb(args.synthetic_tokens, vocab_size=args.vocab_size)
    xs, ys = ptb_windows(ids, args.seq_len)
    data = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(args.batch_size))
    opt = (LocalOptimizer(model, data, lm_criterion(), device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_iteration(args.max_iteration)))
    opt.optimize()
    print(f"final loss: {opt.state['loss']:.4f}")
    return opt.state["loss"]


if __name__ == "__main__":
    main()
