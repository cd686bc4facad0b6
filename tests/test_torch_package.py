"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the GPU unless told otherwise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.lenet import train as lenet_main
from bigdl_tpu_torch.models.resnet import ResNet, ResNet50
from bigdl_tpu_torch.models.resnet import train as resnet_main
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.models.transformerlm import train as train_main
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10
from bigdl_tpu_torch.models.vgg import train as vgg_main
from bigdl_tpu_torch.optim.evaluator import run_device_eval
from bigdl_tpu_torch.optim.validation import Top1Accuracy
from bigdl_tpu_torch.optim import LocalOptimizer
from bigdl_tpu_torch.serving import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
print(len(names), bad)
"""


def test_importing_every_module_leaves_jax_out():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.split(" ", 1)
    assert int(count) >= 55
    assert bad.strip() == "[]", bad


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(16, 8, 2, 1, 8)
    lm = TransformerLM(16, 8, 2, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(lm, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnn.greedy_generate(lm, np.zeros((1, 2), np.int32), 2)
    assert tnn.greedy_generate(lm, np.zeros((1, 2), np.int32), 2,
                               device="cpu").shape == (1, 4)
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt.optimize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main.main(["--max-iteration", "1"])


def test_vision_entry_points_raise_without_cuda(monkeypatch):
    """The vision models, the evaluator and the three vision training
    mains run on the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ResNet(10, {"depth": 8}), ResNet50, LeNet5,
                  VggForCifar10, Vgg_16, Vgg_19):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    lenet = LeNet5(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_device_eval(lenet, DataSet.array([]), [Top1Accuracy()])
    for main in (resnet_main, lenet_main, vgg_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main.main(["--max-epoch", "1", "--synthetic-size", "64"])
