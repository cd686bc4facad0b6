"""PTB LSTM language-model training main of the port.

Counterpart of ``bigdl_tpu/models/rnn/train.py``: ``PTBModel`` over the
words of ``ptb.train.txt`` in ``--folder`` (validated on
``ptb.valid.txt``), or over the synthetic corpus when the folder has no
such file (``dataset/text.load_ptb``), in ``--bptt`` windows, trained with
``SGD(--learning-rate)`` and ``TimeDistributedCriterion(ClassNLLCriterion,
size_average=True)`` through ``LocalOptimizer``, the gradients clipped to
``--clip-norm`` (L2), validated with ``Loss`` at every epoch's end;
``--checkpoint`` and ``--summary-dir`` as the other mains. Prints the final
loss and its perplexity and, with ``--generate N``, beam-decodes N words
from a seed window (``--beam``, ``--alpha``) with ``SequenceBeamSearch``,
with the search's wall time. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.rnn.train -b 64 --bptt 35 \\
        --hidden-size 650 --generate 20
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PTB LSTM LM training "
                                            "(PyTorch port)")
    p.add_argument("-f", "--folder", default=None,
                   help="dir with ptb.train.txt etc.")
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("--vocab-size", type=int, default=10000)
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--bptt", type=int, default=20)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=1.0)
    p.add_argument("--clip-norm", type=float, default=5.0)
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
    p.add_argument("--summary-dir", default=None,
                   help="TensorBoard summary dir")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, beam-decode N tokens from a seed")
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--alpha", type=float, default=0.6,
                   help="beam length-penalty exponent")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def generate(model, dictionary, seed: np.ndarray, n: int, beam: int,
             alpha: float):
    """Beam-decode ``n`` words after ``seed`` (T0 ids) with
    ``SequenceBeamSearch`` over the whole model: ``(best sequence (T0 + n)
    ids, its words, the search's wall seconds)``. A dictionary without an
    ``<eos>`` word (the synthetic corpus) decodes the full length."""
    from bigdl_tpu_torch import nn
    eos = dictionary.get_index("<eos>")
    if dictionary.get_word(eos) != "<eos>":
        eos = -1
    bs = nn.SequenceBeamSearch(model, beam_size=beam, eos_id=eos,
                               decode_length=n, alpha=alpha)
    t0 = time.perf_counter()
    out = bs.forward(np.asarray(seed, np.int64)[None])
    toks = out[1][0, 0].tolist()
    wall = time.perf_counter() - t0
    return toks, [dictionary.get_word(int(t)) for t in toks], wall


def main(argv=None):
    """Train; returns the ``LocalOptimizer`` (``generated``: the decoded
    words and the search's seconds, with ``--generate``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (
        DataSet, Sample, SampleToMiniBatch, load_ptb, ptb_windows,
    )
    from bigdl_tpu_torch.models.rnn import PTBModel
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.validation import Loss

    ids, dictionary = load_ptb(args.folder, "train",
                               vocab_size=args.vocab_size)
    vids, _ = load_ptb(args.folder, "valid", dictionary=dictionary)
    vocab = dictionary.vocab_size()
    xs, ys = ptb_windows(ids, args.bptt)
    vxs, vys = ptb_windows(vids, args.bptt)
    train_set = (DataSet.array([Sample(x, y) for x, y in zip(xs, ys)],
                               distributed=args.distributed)
                 >> SampleToMiniBatch(args.batch_size))
    val_set = (DataSet.array([Sample(x, y) for x, y in zip(vxs, vys)],
                             distributed=args.distributed)
               >> SampleToMiniBatch(args.batch_size))
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                            size_average=True)
    model = PTBModel(vocab, args.hidden_size, num_layers=args.num_layers,
                     dropout=args.dropout,
                     generator=torch.Generator().manual_seed(0),
                     device=args.device)
    optimizer = (trainer(args)(model, train_set, criterion,
                                device=args.device)
                 .set_optim_method(SGD(learningrate=args.learning_rate))
                 .set_end_when(Trigger.max_epoch(args.max_epoch))
                 .set_validation(Trigger.every_epoch(), val_set,
                                 [Loss(criterion)]))
    if args.clip_norm:
        optimizer.set_gradient_clipping_by_l2_norm(args.clip_norm)
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.summary_dir:
        from bigdl_tpu_torch.visualization import (
            TrainSummary, ValidationSummary,
        )
        optimizer.set_train_summary(TrainSummary(args.summary_dir, "ptb"))
        optimizer.set_val_summary(ValidationSummary(args.summary_dir, "ptb"))
    trained = optimizer.optimize()
    loss = optimizer.state["loss"]
    print(f"final loss: {loss:.4f}  perplexity: "
          f"{np.exp(min(loss, 20.0)):.2f}")
    optimizer.generated = None
    if args.generate:
        seed = vxs[0][: max(2, args.bptt // 4)]
        _, words, wall = generate(trained, dictionary, seed, args.generate,
                                  args.beam, args.alpha)
        optimizer.generated = (words, wall)
        print("generated:", " ".join(words))
        print(f"beam search ({args.beam} beams, {args.generate} words): "
              f"{wall:.3f} s")
    return optimizer


if __name__ == "__main__":
    main()
