"""Convergence harness: accuracy parity for the BASELINE configs.

Counterpart of ``bigdl_tpu/convergence.py``: each config trains through
its port main (``--folder <data>`` when a data folder is given) and is
judged against its literature target; one JSON verdict line with JAX's
keys is printed::

    python -m bigdl_tpu_torch.convergence lenet --data /datasets/mnist
    python -m bigdl_tpu_torch.convergence vgg16 --data /datasets/cifar10

Targets are the standard literature values for each architecture and
dataset. With no data folder the mains fall back to their synthetic sets:
the harness still runs end to end, and the verdict says ``synthetic:
true`` with ``achieved: null``, so a synthetic number is never mistaken
for a parity claim. The port trains on the card unless ``--device cpu``
(``device=`` of :func:`converge`); ``--distributed`` trains each main
through ``DistriOptimizer``, as the mains do (one process a rank).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _eval(model, test_set, methods, device):
    from bigdl_tpu_torch.optim import Evaluator
    from bigdl_tpu_torch.utils.device import resolve_device

    res = Evaluator(model, resolve_device(device)).test(test_set, methods)
    return float(res[0][0].result()[0])


def _eval_top1(model, test_samples, batch_size, device):
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.optim import Top1Accuracy

    test_set = DataSet.array(test_samples) >> SampleToMiniBatch(batch_size)
    return _eval(model, test_set, [Top1Accuracy()], device)


def _base_argv(folder, epochs, batch_size, distributed, extra, device):
    argv = ["-b", str(batch_size), "--max-epoch", str(epochs),
            "--device", device]
    if folder:
        argv += ["-f", folder]
    if distributed:
        argv += ["--distributed"]
    return argv + list(extra or ())


def _run_lenet(folder, epochs, batch_size, distributed, extra=(),
               device="cuda"):
    from bigdl_tpu_torch.dataset.mnist import load_mnist, to_samples
    from bigdl_tpu_torch.models.lenet import train as lenet_train

    argv = _base_argv(folder, epochs, batch_size, distributed, extra, device)
    model = lenet_train.main(argv).model
    test = to_samples(*load_mnist(folder, "test"))
    return _eval_top1(model, test, batch_size, device)


def _run_vgg16(folder, epochs, batch_size, distributed, extra=(),
               device="cuda"):
    from bigdl_tpu_torch.dataset.cifar import (
        load_cifar10, normalize, to_samples,
    )
    from bigdl_tpu_torch.models.vgg import train as vgg_train

    argv = _base_argv(folder, epochs, batch_size, distributed, extra, device)
    model = vgg_train.main(argv).model
    imgs, labels = load_cifar10(folder, "test")
    test = to_samples(normalize(imgs), labels)
    return _eval_top1(model, test, batch_size, device)


def _run_imagenet(train_main, folder, epochs, batch_size, distributed,
                  extra=(), device="cuda"):
    from bigdl_tpu_torch.models.imagenet_data import imagenet_sets
    from bigdl_tpu_torch.optim import Top1Accuracy

    argv = _base_argv(folder, epochs, batch_size, distributed, extra, device)
    model = train_main.main(argv).model
    _, val_set = imagenet_sets(folder, batch_size)
    return _eval(model, val_set, [Top1Accuracy()], device)


def _run_resnet50(folder, epochs, batch_size, distributed, extra=(),
                  device="cuda"):
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    return _run_imagenet(resnet_train, folder, epochs, batch_size,
                         distributed, extra, device)


def _run_inception(folder, epochs, batch_size, distributed, extra=(),
                   device="cuda"):
    from bigdl_tpu_torch.models.inception import train as inception_train
    return _run_imagenet(inception_train, folder, epochs, batch_size,
                         distributed, extra, device)


def _run_ptb(folder, epochs, batch_size, distributed, extra=(),
             device="cuda"):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.text import load_ptb, ptb_windows
    from bigdl_tpu_torch.models.rnn import train as rnn_train
    from bigdl_tpu_torch.optim import Loss

    argv = _base_argv(folder, epochs, batch_size, distributed, extra, device)
    model = rnn_train.main(argv).model
    ids, dictionary = load_ptb(folder, "train")
    tids, _ = load_ptb(folder, "test", dictionary=dictionary)
    xs, ys = ptb_windows(tids, 35)
    test_set = (DataSet.array([Sample(x, y) for x, y in zip(xs, ys)])
                >> SampleToMiniBatch(batch_size))
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                            size_average=True)
    mean_loss = _eval(model, test_set, [Loss(criterion)], device)
    return float(np.exp(min(mean_loss, 20.0)))


# config → (runner, metric name, literature target, higher_is_better,
#           default epochs, default batch)
CONFIGS = {
    "lenet": (_run_lenet, "top1", 0.985, True, 5, 128),
    "vgg16": (_run_vgg16, "top1", 0.90, True, 60, 128),
    "resnet50": (_run_resnet50, "top1", 0.747, True, 90, 256),
    "inception": (_run_inception, "top1", 0.689, True, 90, 256),
    "ptb-lstm": (_run_ptb, "perplexity", 120.0, False, 13, 64),
}


def converge(config: str, data_folder: str | None = None,
             epochs: int | None = None, batch_size: int | None = None,
             target: float | None = None, distributed: bool = False,
             extra: tuple = (), device: str = "cuda") -> dict:
    """Train a BASELINE config and judge its final metric against the target.

    Returns the verdict dict (also usable programmatically); ``achieved`` is
    None when the run was synthetic — a fallback dataset can't prove parity.
    """
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}; have {sorted(CONFIGS)}")
    runner, metric, default_target, higher, d_epochs, d_batch = CONFIGS[config]
    target = default_target if target is None else float(target)
    epochs = d_epochs if epochs is None else int(epochs)
    batch_size = d_batch if batch_size is None else int(batch_size)
    value = runner(data_folder, epochs, batch_size, distributed, extra,
                   device)
    synthetic = data_folder is None
    achieved = None if synthetic else (
        value >= target if higher else value <= target)
    return {
        "config": config,
        "metric": metric,
        "value": round(float(value), 4),
        "target": target,
        "achieved": achieved,
        "synthetic": synthetic,
        "epochs": epochs,
        "batch": batch_size,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="accuracy-parity harness for the BASELINE configs")
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--data", default=None,
                   help="real dataset folder (absent → synthetic fallback, "
                        "verdict marked synthetic)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--target", type=float, default=None,
                   help="override the literature target "
                        "(e.g. the reference's published figure)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    # unknown options are forwarded to the config's train main
    # (e.g. --learning-rate 0.1)
    args, rest = p.parse_known_args(argv)
    verdict = converge(args.config, args.data, args.epochs, args.batch_size,
                       args.target, args.distributed, tuple(rest),
                       args.device)
    print(json.dumps(verdict))
    return 0


if __name__ == "__main__":
    sys.exit(main())
