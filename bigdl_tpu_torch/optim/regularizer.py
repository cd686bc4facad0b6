"""Weight regularizers: L1, L2 and L1L2.

Counterpart of ``bigdl_tpu/optim/regularizer.py``. A layer takes them as
``w_regularizer``/``b_regularizer`` (``nn.Linear``), and the trainer adds
their penalty to the loss inside the step, so autograd produces the
gradient terms (``λ·sign(w)``, ``λ·w``) and the reported loss includes the
penalty. Penalties are computed in fp32 whatever the parameter's dtype.
"""

from __future__ import annotations

import torch


class Regularizer:
    def penalty(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class L1Regularizer(Regularizer):
    def __init__(self, l1: float):
        self.l1 = float(l1)

    def penalty(self, w):
        return self.l1 * w.float().abs().sum()


class L2Regularizer(Regularizer):
    def __init__(self, l2: float):
        self.l2 = float(l2)

    def penalty(self, w):
        # the reference's L2: λ/2·‖w‖² (gradient λ·w)
        return 0.5 * self.l2 * w.float().square().sum()


class L1L2Regularizer(Regularizer):
    def __init__(self, l1: float, l2: float):
        self.l1, self.l2 = float(l1), float(l2)

    def penalty(self, w):
        w = w.float()
        return self.l1 * w.abs().sum() + 0.5 * self.l2 * w.square().sum()
