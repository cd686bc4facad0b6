"""Transformer LM training main of the port, on the synthetic token stream.

Counterpart of ``bigdl_tpu/models/transformerlm/train.py``: builds
``TransformerLM``, slices ``synthetic_ptb`` (or, with ``--folder FILE``,
the words of that text file through ``SentenceTokenizer`` and a
``Dictionary`` of ``--vocab-size`` words) into windows of ``--seq-len``
tokens, and trains with ``Adam`` through ``LocalOptimizer`` for
``--max-iteration`` steps, then prints the final loss and, with
``--generate N``, beam-decodes N tokens from a seed. ``--lora RANK``
adapts every attention and Linear at that rank (``nn.apply_lora``) and
trains only the adapters. ``--model-snapshot FILE`` starts from a saved
module (either format, JAX's files too; the vocabulary, fused head, rope
and ``max_len`` come from the model, as in JAX) and ``--save FILE`` writes
the trained model in the portable format. Runs on the card
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

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transformer LM training "
                                            "(PyTorch port)")
    p.add_argument("-f", "--folder", default=None,
                   help="a text file to train on (default: the synthetic "
                        "corpus)")
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--model-snapshot", default=None,
                   help="start from a saved model archive (fine-tuning); "
                        "vocab/seq-len/rope/fused-head are read from the "
                        "model, not these flags")
    p.add_argument("--save", default=None,
                   help="save the trained model archive here")
    p.add_argument("--lora", type=int, default=0, metavar="RANK",
                   help="LoRA fine-tune: adapt the attention and Linear "
                        "layers at this rank, freeze everything else")
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
    add_distributed_flag(p)
    return p


def main(argv=None) -> float:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (
        DataSet, Dictionary, Sample, SampleToMiniBatch, SentenceTokenizer,
        ptb_windows, synthetic_ptb,
    )
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(0)
    if args.lora and not args.model_snapshot:
        print("WARNING: --lora without --model-snapshot freezes a RANDOM "
              "base and trains only the adapters — this is almost never "
              "what you want (LoRA fine-tunes a pretrained model)")
    if args.model_snapshot:
        from bigdl_tpu_torch.models.transformerlm import PositionEmbedding
        model = nn.AbstractModule.load(args.model_snapshot, args.device)
        # trust the MODEL, not the flags, for everything structural
        mods = list(model.modules())
        args.fused_head = any(isinstance(m, nn.FusedLMHead) for m in mods)
        args.rope = any(getattr(m, "rope", False) for m in mods
                        if isinstance(m, nn.MultiHeadAttention))
        emb = [m for m in mods if isinstance(m, nn.LookupTable)]
        if emb and emb[0].n_index != args.vocab_size:
            print(f"snapshot vocab {emb[0].n_index} overrides "
                  f"--vocab-size {args.vocab_size}")
            args.vocab_size = emb[0].n_index
        pos = [m for m in mods if isinstance(m, PositionEmbedding)]
        if pos and args.seq_len > pos[0].max_len:
            print(f"snapshot max_len {pos[0].max_len} caps "
                  f"--seq-len {args.seq_len}")
            args.seq_len = pos[0].max_len
    else:
        model = TransformerLM(args.vocab_size, args.embed_dim,
                              args.num_heads, args.num_layers,
                              max_len=args.seq_len, dropout=args.dropout,
                              remat=args.remat, fused_head=args.fused_head,
                              num_kv_heads=args.num_kv_heads,
                              position="rope" if args.rope else "learned",
                              norm=args.norm, mlp_kind=args.mlp,
                              generator=torch.Generator().manual_seed(0),
                              device=args.device)
    if args.lora:
        if any(isinstance(m, nn.LoRALinear)
               or getattr(m, "lora_rank", None) for m in model.modules()):
            print("snapshot already carries LoRA adapters — resuming "
                  "fine-tuning with them (bases stay frozen)")
        else:
            n = nn.apply_lora(model, rank=args.lora,
                              generator=torch.Generator().manual_seed(1))
            print(f"LoRA: adapted {n} modules at rank {args.lora} "
                  f"(base frozen)")
    if args.folder is not None:
        with open(args.folder) as f:
            tokens = SentenceTokenizer().tokens(f.read())
        vocab = Dictionary(tokens, vocab_size=args.vocab_size)
        ids = np.asarray([vocab.get_index(t) for t in tokens], np.int32)
    else:
        ids = synthetic_ptb(args.synthetic_tokens,
                            vocab_size=args.vocab_size)
    xs, ys = ptb_windows(ids, args.seq_len)
    data = (DataSet.array((Sample(x, y) for x, y in zip(xs, ys)),
                          distributed=args.distributed)
            >> SampleToMiniBatch(args.batch_size))
    opt = (trainer(args)(model, data,
                          lm_criterion(fused_head=args.fused_head),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_iteration(args.max_iteration)))
    opt.optimize()
    print(f"final loss: {opt.state['loss']:.4f}")
    if args.save:
        model.save_module(args.save)
        print(f"saved to {args.save}")
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
