"""Seq2seq Transformer training main of the port.

Counterpart of ``bigdl_tpu/models/transformer/train.py``: trains on a
synthetic reversal "translation" corpus (the target is the reversed
source, drawn from ``np.random.default_rng(0)`` as JAX draws it) or on a
file of tab-separated ``src-ids<TAB>tgt-ids`` lines (``--folder``), with
``Adam`` through ``LocalOptimizer`` for ``--max-epoch`` epochs, prints the
final loss and, with ``--translate N``, beam-translates N held-out rows
through the KV-cached ``translate_generate``. Each sample is
``Sample((src, bos + tgt), tgt + eos)``: a two-tensor input. Runs on the
card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.transformer.train -b 32 --seq-len 256 \\
        --src-vocab 37000 --tgt-vocab 37000 --embed-dim 512 --num-heads 8 \\
        --num-encoder-layers 6 --num-decoder-layers 6 --max-epoch 1
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
    p = argparse.ArgumentParser(description="seq2seq Transformer training "
                                            "(PyTorch port)")
    p.add_argument("-f", "--folder", default=None,
                   help="file of 'src-ids<TAB>tgt-ids' lines "
                        "(space-separated)")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--src-vocab", type=int, default=32)
    p.add_argument("--tgt-vocab", type=int, default=34)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--num-encoder-layers", type=int, default=2)
    p.add_argument("--num-decoder-layers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--max-epoch", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--translate", type=int, default=0, metavar="N",
                   help="after training, beam-translate N held-out rows")
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def special_ids(args) -> tuple:
    """``(bos, eos, payload)``: the top two target ids are BOS and EOS; the
    synthetic tokens are drawn below ``payload``."""
    return (args.tgt_vocab - 2, args.tgt_vocab - 1,
            min(args.src_vocab, args.tgt_vocab - 2))


def read_pairs(args) -> tuple:
    """The ``--folder`` file's ``(sources, targets)``, each line checked as
    JAX checks it; sets ``args.seq_len`` to the longer side's length."""
    bos = special_ids(args)[0]
    pairs = []
    with open(args.folder) as f:
        for ln, line in enumerate(f, 1):
            s, t = line.rstrip("\n").split("\t")
            pairs.append((np.asarray(s.split(), np.int32),
                          np.asarray(t.split(), np.int32)))
            if pairs[-1][0].max(initial=0) >= args.src_vocab:
                raise SystemExit(f"{args.folder}:{ln}: src id "
                                 f">= --src-vocab {args.src_vocab}")
            if pairs[-1][1].max(initial=0) >= bos:
                raise SystemExit(
                    f"{args.folder}:{ln}: tgt id >= {bos} (the top two "
                    f"--tgt-vocab ids are reserved for bos/eos)")
    lens_s = {len(p[0]) for p in pairs}
    lens_t = {len(p[1]) for p in pairs}
    if len(lens_s) != 1 or len(lens_t) != 1:
        raise SystemExit(f"{args.folder}: ragged lines (src lens "
                         f"{sorted(lens_s)}, tgt lens {sorted(lens_t)}); "
                         f"pad to uniform length")
    args.seq_len = max(lens_s.pop(), lens_t.pop())
    return [p[0] for p in pairs], [p[1] for p in pairs]


def corpus(args, rng: np.random.Generator) -> tuple:
    """``(sources, targets)``: the ``--folder`` file's, or the synthetic
    reversal corpus of ``--synthetic-size`` rows of ``--seq-len`` tokens."""
    if args.folder:
        return read_pairs(args)
    src = rng.integers(0, special_ids(args)[2],
                       (args.synthetic_size, args.seq_len))
    return list(src.astype(np.int32)), list(src[:, ::-1].astype(np.int32))


def samples(args, srcs, tgts) -> list:
    """``Sample((src, bos + tgt), tgt + eos)`` for every pair."""
    from bigdl_tpu_torch.dataset import Sample

    bos, eos, _ = special_ids(args)
    return [Sample((s, np.concatenate([[bos], t]).astype(np.int32)),
                   np.concatenate([t, [eos]]).astype(np.int32))
            for s, t in zip(srcs, tgts)]


def build_model(args, device=None, attention_impl: str = "auto"):
    """The main's model, its weights drawn from seed 0."""
    from bigdl_tpu_torch.models.transformer import Transformer

    return Transformer(args.src_vocab, args.tgt_vocab, args.embed_dim,
                       args.num_heads, args.num_encoder_layers,
                       args.num_decoder_layers, max_len=args.seq_len + 2,
                       dropout=args.dropout, attention_impl=attention_impl,
                       generator=torch.Generator().manual_seed(0),
                       device=device)


def criterion():
    from bigdl_tpu_torch import nn

    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


def main(argv=None) -> float:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.transformer import translate_generate
    from bigdl_tpu_torch.optim import Adam, Trigger

    rng = np.random.default_rng(0)
    srcs, tgts = corpus(args, rng)
    data = (DataSet.array(samples(args, srcs, tgts),
                          distributed=args.distributed)
            >> SampleToMiniBatch(args.batch_size))
    model = build_model(args, args.device)
    opt = (trainer(args)(model, data, criterion(), device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch)))
    opt.optimize()
    print(f"final loss: {opt.state['loss']:.4f}")

    if args.translate:
        bos, eos, payload = special_ids(args)
        if args.folder:
            # no held-out split is defined for a user file: translate its
            # first rows and say so
            hsrc, origin = np.stack(srcs[: args.translate]), "training-file"
        else:
            hsrc = rng.integers(0, payload, (args.translate, args.seq_len)
                                ).astype(np.int32)
            origin = "held-out"
        seqs, scores = translate_generate(
            model, hsrc, beam_size=args.beam, eos_id=eos, bos_id=bos,
            decode_length=hsrc.shape[1] + 1, device=args.device)
        for n in range(len(hsrc)):
            print(f"{origin} src: {hsrc[n].tolist()}  ->  "
                  f"tgt: {seqs[n, 0, 1:].tolist()} "
                  f"(score {float(scores[n, 0]):.2f})")
    return opt.state["loss"]


if __name__ == "__main__":
    main()
