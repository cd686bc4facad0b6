"""On-device image normalisation.

Counterpart of ``bigdl_tpu/nn/misc.py:706`` ``ImageNormalize`` (the only
class of that module on the port's path): ``(x * scale - mean) / std`` per
channel, the channel axis from ``nn/layout.py``. The feed stays uint8 and
the layer casts it on the device: to the engine's compute dtype when the
engine is initialised (bf16 under the mixed policy, so the whole model runs
in bf16, as JAX's does), else fp32. ``scale``, mean and std are rounded to
the input's dtype before the arithmetic, as ``jnp.asarray(v, x.dtype)``
rounds them.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.utils.engine import Engine


class ImageNormalize(TensorModule):
    """ImageNet mean and std (0–1 range) with ``scale=1/255`` for uint8
    pixels by default; ``scale=1.0`` for pre-scaled float input."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 scale: float = 1.0 / 255.0):
        super().__init__()
        mean = mean if isinstance(mean, (tuple, list)) else (mean,)
        std = std if isinstance(std, (tuple, list)) else (std,)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        if len(self.mean) != len(self.std):
            raise ValueError(
                f"ImageNormalize: mean has {len(self.mean)} channels but std "
                f"has {len(self.std)}: they must pair up")
        self.scale = float(scale)
        # (scale, mean..., std...) on the module's device, so that a
        # captured program copies nothing from the host
        self.register_buffer("consts", torch.tensor(
            (self.scale,) + self.mean + self.std, dtype=torch.float64),
            persistent=False)

    def run(self, input, state=None):
        x = input
        if not x.is_floating_point():
            x = x.to(Engine.compute_dtype() if Engine.is_initialized()
                     else torch.float32)
        n = len(self.mean)
        shape = layout.bias_shape(n, x.dim()) if x.dim() >= 3 else (n,)
        c = self.consts.to(x.dtype)
        mean = c[1:1 + n].reshape(shape)
        std = c[1 + n:].reshape(shape)
        return (x * c[0] - mean) / std, state

    def extra_repr(self):
        return f"mean={self.mean}, std={self.std}, scale={self.scale:g}"
