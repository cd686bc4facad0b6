"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the GPU unless told otherwise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.transformerlm import TransformerLM
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
    assert int(count) >= 20
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
