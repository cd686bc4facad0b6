"""Flat-parameter optimizer update: a few vector ops per step instead of a
handful per parameter tensor.

Counterpart of ``bigdl_tpu/kernels/fused_update.py`` (an XLA-level fusion
in JAX, not a Pallas kernel, so it ports as torch code). A model's
parameters are many tensors, and an elementwise method (SGD, Adam, ...)
launches a few small kernels for each; on models with many norms and biases
the launches outweigh the arithmetic. :class:`FlatParamUpdate` groups the
parameters by dtype into one flat buffer each and makes every parameter a
view into its group's buffer (``p.data = buffer[offset:offset + n]``), so
the model computes with the same tensors as before while the inner
method's update runs once over each buffer. Gradients are concatenated
into matching flat vectors (one copy per group) and the slots are created
flat and stay flat.

An elementwise update computes each element with the same operations
whether it runs over one tensor or a flat buffer, so the result is bit for
bit that of the per-leaf update (``tests/test_torch_optim_surface.py``).
Methods with per-leaf behaviour (``layer_lr_mults``, LARS, L-BFGS,
composite routing) are not flat-eligible (:func:`flat_supported`) and keep
the per-leaf path, as in JAX.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod, leaves


def flat_supported(method) -> bool:
    """Can ``method`` run on flat vectors? It must be purely elementwise
    (``elementwise_update``) and have no per-layer rate multipliers."""
    if isinstance(method, FlatParamUpdate):
        return False
    if getattr(method, "layer_lr_mults", None):
        return False
    return bool(getattr(method, "elementwise_update", False))


def _groups(tensors) -> dict:
    """``{dtype: [index, ...]}`` of the non-empty tensors, dtypes in
    first-seen order. Empty tensors (frozen stand-ins) join no group."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        if t.numel():
            groups.setdefault(t.dtype, []).append(i)
    return groups


class FlatParamUpdate(OptimMethod):
    """Run an elementwise :class:`OptimMethod` over one flat buffer per
    parameter dtype. ``init_state`` moves the parameters into the buffers
    (each parameter becomes a view of its buffer); the state holds the
    buffers (``"flat"``) and the inner method's flat slots (``"slots"``)."""

    def __init__(self, inner: OptimMethod):
        self.inner = inner

    def init_state(self, params) -> dict:
        ps = leaves(params)
        flats = []
        with torch.no_grad():
            for idx in _groups(ps).values():
                buf = torch.cat([ps[i].detach().reshape(-1) for i in idx])
                off = 0
                for i in idx:
                    n = ps[i].numel()
                    ps[i].data = buf[off:off + n].view_as(ps[i])
                    off += n
                flats.append(buf)
        return {"flat": flats, "slots": self.inner.init_state(flats)}

    def update(self, params, grads, state, step):
        ps, gs = leaves(params), leaves(grads)
        groups = list(_groups(ps).values())
        flats = state["flat"]
        if len(groups) != len(flats):
            raise RuntimeError("FlatParamUpdate: the parameters' dtype groups "
                               "changed since init_state")
        gflat = []
        for idx, buf in zip(groups, flats):
            ptr, item = buf.data_ptr(), buf.element_size()
            for i in idx:
                if ps[i].data_ptr() != ptr:
                    raise RuntimeError(
                        "FlatParamUpdate: a parameter no longer lives in its "
                        "flat buffer (replaced after init_state?); reset the "
                        "optimizer state")
                ptr += ps[i].numel() * item
            gflat.append(torch.cat([gs[i].reshape(-1) for i in idx]))
        self.inner.update(flats, gflat, state["slots"], step)

    def get_learning_rate(self, step: int) -> float:
        return self.inner.get_learning_rate(step)

    def __repr__(self):
        return f"FlatParamUpdate({self.inner!r})"
