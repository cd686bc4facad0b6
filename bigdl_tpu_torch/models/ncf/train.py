"""NCF training main of the port, on synthetic implicit feedback.

Counterpart of ``bigdl_tpu/models/ncf/train.py`` with its flags and
defaults: clustered synthetic interactions (users prefer one of 8 item
clusters), each user's last positive held out, ``--neg-ratio`` sampled
negatives a positive for training, NeuMF trained with ``ClassNLLCriterion``
through ``LocalOptimizer``, then HitRatio@k and NDCG@k over groups of the
held-out positive and ``--eval-neg-num`` sampled negatives, folded on the
device (``run_device_eval``). ``--sharded`` wraps the tables in
``ShardedEmbedding`` (sparse row updates), ``--hash-buckets N`` hashes the
ids. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.ncf.train --sharded
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
    p = argparse.ArgumentParser(
        description="NeuralCF on implicit interactions (PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--max-epoch", type=int, default=4)
    p.add_argument("--user-count", type=int, default=200)
    p.add_argument("--item-count", type=int, default=100)
    p.add_argument("--interactions", type=int, default=8192)
    p.add_argument("--neg-ratio", type=int, default=3,
                   help="training negatives per positive")
    p.add_argument("--eval-neg-num", type=int, default=20,
                   help="candidates per HR/NDCG group = eval_neg_num + 1")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--hash-buckets", type=int, default=0,
                   help=">0: use the hashing trick instead of dense vocab")
    p.add_argument("--sharded", action="store_true",
                   help="wrap the tables in parallel.ShardedEmbedding: "
                        "deduplicated gathers and sparse row updates")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def synthetic_interactions(user_count: int, item_count: int, n: int, seed=0):
    """JAX's clustered implicit feedback, draw for draw: users prefer one
    of 8 item clusters (80% of positives), the rest uniform."""
    rng = np.random.default_rng(seed)
    n_clusters = 8
    user_cluster = rng.integers(0, n_clusters, size=user_count)
    item_cluster = rng.integers(0, n_clusters, size=item_count)
    users = rng.integers(0, user_count, size=n)
    members = [np.flatnonzero(item_cluster == c) for c in range(n_clusters)]
    pos_items = np.empty(n, np.int64)
    for idx in range(n):
        own = members[user_cluster[users[idx]]]
        if rng.random() < 0.8 and len(own):
            pos_items[idx] = rng.choice(own)
        else:
            pos_items[idx] = rng.integers(0, item_count)
    return users, pos_items, user_cluster, item_cluster


def build_training_samples(users, pos_items, item_count, neg_ratio, seed=1):
    """JAX's samples: (user+1, item+1) pairs, class 1 for a positive and 0
    for each of its ``neg_ratio`` uniform negatives, shuffled."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(seed)
    samples = []
    for u, i in zip(users, pos_items):
        samples.append(Sample(np.asarray([u + 1, i + 1], np.int32),
                              np.int32(1)))
        for _ in range(neg_ratio):
            j = rng.integers(0, item_count)
            samples.append(Sample(np.asarray([u + 1, j + 1], np.int32),
                                  np.int32(0)))
    rng.shuffle(samples)
    return samples


def build_eval_batches(users, pos_items, item_count, neg_num, batch_groups=8,
                       seed=2):
    """JAX's eval batches: groups of the positive and ``neg_num`` negatives
    (never the positive item), ``batch_groups`` whole groups a batch."""
    from bigdl_tpu_torch.dataset import MiniBatch
    rng = np.random.default_rng(seed)
    batches, feats, labels = [], [], []
    for u, i in zip(users, pos_items):
        cand = [(u + 1, i + 1, 1)]
        while len(cand) < neg_num + 1:
            j = int(rng.integers(0, item_count))
            if j != i:
                cand.append((u + 1, j + 1, 0))
        for uu, ii, y in cand:
            feats.append([uu, ii])
            labels.append(y)
        if len(feats) >= batch_groups * (neg_num + 1):
            batches.append(MiniBatch(np.asarray(feats, np.int32),
                                     np.asarray(labels, np.int32)))
            feats, labels = [], []
    if feats:
        batches.append(MiniBatch(np.asarray(feats, np.int32),
                                 np.asarray(labels, np.int32)))
    return batches


def holdout_split(users):
    """Each user's last interaction is held out (JAX's leave-one-out):
    ``(train_mask, [(user, index of its held-out interaction), ...])``."""
    last_idx = {}
    for idx, u in enumerate(users):
        last_idx[int(u)] = idx
    holdout = set(last_idx.values())
    train_mask = np.array([i not in holdout for i in range(len(users))])
    return train_mask, sorted(last_idx.items())


def main(argv=None):
    """Train and evaluate; returns ``(hit_ratio, ndcg)``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax(always=True)
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.ncf import NeuralCF
    from bigdl_tpu_torch.optim import (
        NDCG, SGD, Adam, HitRatio, Trigger,
    )
    from bigdl_tpu_torch.optim.evaluator import run_device_eval

    users, pos_items, _, _ = synthetic_interactions(
        args.user_count, args.item_count, args.interactions)
    train_mask, eval_pairs = holdout_split(users)
    train_samples = build_training_samples(
        users[train_mask], pos_items[train_mask], args.item_count,
        args.neg_ratio)
    data = DataSet.array(train_samples,
                         distributed=args.distributed) >> SampleToMiniBatch(args.batch_size)

    model = NeuralCF(args.user_count, args.item_count, class_num=2,
                     hash_buckets=args.hash_buckets, sharded=args.sharded,
                     generator=torch.Generator().manual_seed(0),
                     device=args.device)
    if args.optimizer == "adam":
        method = Adam(learningrate=args.learning_rate)
    else:
        method = SGD(learningrate=args.learning_rate, momentum=0.9,
                     dampening=0.0)
    opt = (trainer(args)(model, data, nn.ClassNLLCriterion(),
                          device=args.device)
           .set_optim_method(method)
           .set_end_when(Trigger.max_epoch(args.max_epoch)))
    opt.optimize()

    eval_users = np.asarray([u for u, _ in eval_pairs])
    eval_items = np.asarray([pos_items[i] for _, i in eval_pairs])
    batches = build_eval_batches(eval_users, eval_items, args.item_count,
                                 args.eval_neg_num)
    hr = HitRatio(k=args.k, neg_num=args.eval_neg_num)
    ndcg = NDCG(k=args.k, neg_num=args.eval_neg_num)
    (hr_res, ndcg_res), _ = run_device_eval(
        model, DataSet.array(batches), [hr, ndcg], device=args.device)
    hr_v, n = hr_res.result()
    ndcg_v, _ = ndcg_res.result()
    random_hr = args.k / (args.eval_neg_num + 1)
    print(f"final loss: {opt.state['loss']:.6f}")
    print(f"HitRatio@{args.k}: {hr_v:.4f} over {n} groups "
          f"(uniform-random baseline {random_hr:.4f})")
    print(f"NDCG@{args.k}: {ndcg_v:.4f}")
    return hr_v, ndcg_v


if __name__ == "__main__":
    main()
