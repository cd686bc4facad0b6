"""SSD training main of the port, on synthetic shapes.

Counterpart of ``bigdl_tpu/models/ssd/train.py`` with its flags and
defaults: the two-scale SSD trains on bright (class 1) and dim (class 2)
squares, one an image, with Adam and ``MultiBoxCriterion``, then reports
the held-out IoU of the top detection through ``detector``. Runs on the
card unless ``--device cpu``; ``--save FILE`` writes the trained model in
the portable format (``utils/serializer.py``); ``--distributed`` trains
with ``DistriOptimizer`` over the Engine mesh, one process a rank::

    python -m bigdl_tpu_torch.models.ssd.train
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
        description="SSD on synthetic shapes (PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--max-epoch", type=int, default=20)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--save", default=None, help="save trained model here")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def make_dataset(n: int, img: int, rng: np.random.RandomState):
    """JAX's samples, draw for draw: bright squares class 1, dim squares
    class 2, one an image; gt rows (1, 5) ``[label, x1, y1, x2, y2]``
    normalised."""
    from bigdl_tpu_torch.dataset import Sample
    out = []
    for _ in range(n):
        x = rng.rand(3, img, img).astype(np.float32) * 0.1
        side = rng.randint(img // 8, img // 4)
        y0 = rng.randint(0, img - side)
        x0 = rng.randint(0, img - side)
        cls = rng.randint(1, 3)
        x[:, y0:y0 + side, x0:x0 + side] = 1.0 if cls == 1 else 0.55
        gt = np.array([[cls, x0 / img, y0 / img,
                        (x0 + side) / img, (y0 + side) / img]], np.float32)
        out.append(Sample(x, gt))
    return out


def main(argv=None):
    """Train; returns the held-out mean IoU."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.ssd import SSD, detector
    from bigdl_tpu_torch.optim import Adam, Trigger

    rng = np.random.RandomState(0)
    n_cls = 3   # bg + bright + dim
    train = make_dataset(args.n_train, args.img_size, rng)
    data = DataSet.array(train, distributed=args.distributed) >> SampleToMiniBatch(args.batch_size)
    model = SSD(n_cls, img_size=args.img_size,
                generator=torch.Generator().manual_seed(0),
                device=args.device)
    opt = (trainer(args)(model, data, nn.MultiBoxCriterion(n_classes=n_cls),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch)))
    opt.optimize()
    print(f"final loss: {float(opt.state['loss']):.4f}")

    serve = detector(model, n_cls, keep_topk=1, conf_thresh=0.01)
    test = make_dataset(32, args.img_size, rng)
    ious, cls_ok = [], 0
    for s in test:
        x = torch.from_numpy(s.feature[0][None]).to(args.device)
        det = serve(x)[0, 0].cpu()
        gt = torch.from_numpy(s.label[0][0])
        ious.append(float(nn.pairwise_iou(det[None, 2:], gt[None, 1:])[0, 0]))
        cls_ok += int(det[0] == gt[0])
    print(f"held-out mean IoU: {np.mean(ious):.3f}  "
          f"class acc: {cls_ok / len(test):.3f}")
    if args.save:
        model.save_module(args.save)
        print(f"saved to {args.save}")
    return float(np.mean(ious))


if __name__ == "__main__":
    main()
