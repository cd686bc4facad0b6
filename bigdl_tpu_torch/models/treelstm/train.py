"""TreeLSTM sentiment training main of the port.

Counterpart of ``bigdl_tpu/models/treelstm/train.py``: a synthetic
sentiment task over random binary parse trees (leaf tokens carry
positive, negative or neutral valence; the root's label is the majority's
sign), a ``Graph`` of ``SelectTable -> LookupTable -> BinaryTreeLSTM ->
Select(root) -> Linear -> LogSoftMax`` trained with ``Adam`` and
``ClassNLLCriterion`` through ``LocalOptimizer``, validated with
``TreeNNAccuracy`` (its device fold) on the last tenth at every epoch's
end. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.treelstm.train
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BinaryTreeLSTM sentiment "
                                            "(PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=2e-3)
    p.add_argument("--max-epoch", type=int, default=6)
    p.add_argument("--trees", type=int, default=2048)
    p.add_argument("--leaves", type=int, default=8, help="leaves per tree")
    p.add_argument("--vocab-size", type=int, default=60)
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def random_tree(n_leaves: int, rng):
    """A random binary tree over ``n_leaves`` leaves: ``(children (2L-1,
    2) int32, leaf_slot (L,) int32)``, numbered root first (node 0) in
    depth-first order, so children have larger indices than their parent
    (the order ``BinaryTreeLSTM`` sweeps); a leaf's children are -1. The
    same draws as JAX's."""
    nodes = []
    frags = [("leaf", i) for i in range(n_leaves)]
    while len(frags) > 1:
        i = rng.integers(0, len(frags) - 1)
        a, b = frags[i], frags[i + 1]
        nodes.append((a, b))
        frags[i: i + 2] = [("node", len(nodes) - 1)]
    total = 2 * n_leaves - 1
    children = np.full((total, 2), -1, np.int32)
    leaf_slot = np.full(n_leaves, -1, np.int32)
    counter = [0]

    def assign(ref):
        kind, idx = ref
        my = counter[0]
        counter[0] += 1
        if kind == "leaf":
            leaf_slot[idx] = my
        else:
            left, right = nodes[idx]
            children[my] = (assign(left), assign(right))
        return my

    assign(frags[0])
    return children, leaf_slot


def synthetic_trees(n, n_leaves, vocab_size, seed=0):
    """``Sample((ids, children), label)``s: tokens below v/3 positive, below
    2v/3 negative, the rest neutral; ids are tokens + 1 at the leaves and 0
    at internal nodes; the label is 1 when positives outnumber
    negatives."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(seed)
    third = vocab_size // 3
    samples = []
    total = 2 * n_leaves - 1
    for _ in range(n):
        children, leaf_slot = random_tree(n_leaves, rng)
        tokens = rng.integers(0, vocab_size, size=n_leaves)
        ids = np.zeros(total, np.int32)
        ids[leaf_slot] = tokens + 1
        score = int((tokens < third).sum()) - int(
            ((tokens >= third) & (tokens < 2 * third)).sum())
        samples.append(Sample((ids, children), np.int32(1 if score > 0
                                                         else 0)))
    return samples


def build_model(vocab_size: int, embed_dim: int, hidden: int,
                class_num: int = 2, *,
                generator: Optional[torch.Generator] = None, device=None):
    """The ``Graph``: ids -> embedding, (embedding, children) ->
    ``BinaryTreeLSTM`` -> the root's state -> Linear -> LogSoftMax."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.device import resolve_device
    g = generator
    inp = nn.Input()
    ids = nn.SelectTable(1).inputs(inp)
    children = nn.SelectTable(2).inputs(inp)
    emb = nn.LookupTable(vocab_size + 1, embed_dim, zero_based=True,
                         generator=g).inputs(ids)
    h = nn.BinaryTreeLSTM(embed_dim, hidden, generator=g).inputs(emb,
                                                                  children)
    root = nn.Select(2, 1).inputs(h)
    out = nn.Linear(hidden, class_num, generator=g).inputs(root)
    out = nn.LogSoftMax().inputs(out)
    return nn.Graph(inp, out).to(resolve_device(device))


def main(argv=None):
    """Train; returns the ``LocalOptimizer``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax(always=True)
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.optim.validation import TreeNNAccuracy

    samples = synthetic_trees(args.trees, args.leaves, args.vocab_size)
    split = int(0.9 * len(samples))
    train = DataSet.array(samples[:split],
                          distributed=args.distributed) >> SampleToMiniBatch(
        args.batch_size)
    test = DataSet.array(samples[split:]) >> SampleToMiniBatch(
        args.batch_size)
    model = build_model(args.vocab_size, args.embed_dim, args.hidden,
                        generator=torch.Generator().manual_seed(0),
                        device=args.device)
    opt = (trainer(args)(model, train, nn.ClassNLLCriterion(),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test, [TreeNNAccuracy()]))
    opt.optimize()
    acc = opt.state["scores"]["TreeNNAccuracy"]
    print(f"final loss: {opt.state['loss']:.4f}, TreeLSTM held-out "
          f"TreeNNAccuracy (root): {acc:.4f}")
    return opt


if __name__ == "__main__":
    main()
