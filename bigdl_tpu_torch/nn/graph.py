"""The conv-BN fusion pass of ``bigdl_tpu/nn/graph.py``.

Counterpart of ``fuse_conv_bn`` (``:255``) and its helpers
(``_fusible_conv``, ``_fusible_bn``, ``_is_relu``, ``_fuse_sequential``)
over the module tree. The ``Graph``/``Input`` DAG and its branch of the pass
come with the Inception slice (ROADMAP Queue A.4).
"""

from __future__ import annotations

import logging

from bigdl_tpu_torch.nn.abstractnn import Container

logger = logging.getLogger(__name__)


def _fusible_conv(m) -> bool:
    from bigdl_tpu_torch.nn.convolution import SpatialConvolution
    return isinstance(m, SpatialConvolution)


def _fusible_bn(conv, m) -> bool:
    from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
    return (isinstance(m, SpatialBatchNormalization)
            and m.n_output == conv.n_output_plane)


def _is_relu(m) -> bool:
    from bigdl_tpu_torch.nn.activation import ReLU
    return type(m) is ReLU


def _fuse_sequential(seq) -> int:
    """Collapse adjacent conv → bn (→ relu) children of a Sequential into
    ``FusedConvBNReLU`` modules, in place; the fused module keeps the index
    of its convolution, so the children are renumbered as JAX's list is.
    Returns the number of pairs fused."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    mods = list(seq._modules.values())
    out, fused, i = [], 0, 0
    while i < len(mods):
        m = mods[i]
        if (_fusible_conv(m) and i + 1 < len(mods)
                and _fusible_bn(m, mods[i + 1])):
            relu = i + 2 < len(mods) and _is_relu(mods[i + 2])
            out.append(FusedConvBNReLU(m, mods[i + 1], relu=relu))
            fused += 1
            i += 3 if relu else 2
        else:
            out.append(m)
            i += 1
    if fused:
        seq._modules.clear()
        for m in out:
            seq.add(m)
    return fused


def fuse_conv_bn(model):
    """Walk the module tree and replace each adjacent
    ``SpatialConvolution → SpatialBatchNormalization (→ ReLU)`` of a
    Sequential by one ``kernels.conv_bn.FusedConvBNReLU`` that owns the same
    modules (parameters and running statistics carry over untouched).
    Rewrites containers in place and returns the model."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    from bigdl_tpu_torch.nn.containers import Sequential

    total = 0

    def walk(m):
        nonlocal total
        if isinstance(m, FusedConvBNReLU):
            return
        if isinstance(m, Container):
            for c in m.children():
                walk(c)
            if isinstance(m, Sequential):
                total += _fuse_sequential(m)

    walk(model)
    if total:
        logger.info("conv-bn fusion pass: %d conv-bn(-relu) chains fused",
                    total)
    return model
