"""Move weights and module state from the JAX package into the port by
path.

The JAX ``model.get_params()`` tree nests dicts by container child index
(``"0"``, ``"1"``, ...) down to the leaf key names (``weight``,
``qkv_weight``, ``pos``, ...; grouped-query attention's ``q_weight``,
``kv_weight`` and their biases, RMSNorm's and ``FusedLMHead``'s
``weight``/``bias``, the ``"0"`` level a ``Remat`` block adds; a
convolution's and batch norm's ``weight``/``bias``). The port registers its
parameters under the same names in the same tree, so a leaf's dotted path
in the JAX tree is the name of the port's parameter (:func:`load_jax_params`).

The JAX ``model.get_state()`` tree nests the same way down to the module
state's leaves: batch norm's ``running_mean`` and ``running_var`` (the only
state leaves of the ported modules; stateless modules give empty dicts).
The port keeps them as persistent buffers of the same names
(:func:`load_jax_state`).
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of arrays → ``{"a.b.c": array}`` (empty dicts vanish)."""
    flat = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            flat.update(flatten_tree(node, path + "."))
        else:
            flat[path] = node
    return flat


def load_jax_params(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy every leaf of ``tree`` (nested dicts of numpy arrays) into the
    parameter of ``module`` with the same path. Raises ``KeyError`` on a
    missing or extra key and ``ValueError`` on a shape mismatch, before any
    parameter is written."""
    return _load(dict(module.named_parameters()), tree, "parameter", module)


def load_jax_state(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy every leaf of the JAX state tree (``get_state()``: batch norm's
    ``running_mean`` and ``running_var``) into the persistent buffer of
    ``module`` with the same path, with :func:`load_jax_params`' checks:
    ``KeyError`` on a missing or extra path, ``ValueError`` on a shape
    mismatch, nothing written before every leaf has passed."""
    params = {n for n, _ in module.named_parameters()}
    buffers = {n: b for n, b in module.state_dict(keep_vars=True).items()
               if n not in params}
    return _load(buffers, tree, "state", module)


def _load(params: dict, tree: dict, kind: str,
          module: torch.nn.Module) -> torch.nn.Module:
    flat = flatten_tree(tree)
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"{kind} paths differ: missing from the tree "
                       f"{missing}, not in the module {extra}")
    arrays = {}
    for path, p in params.items():
        a = np.asarray(flat[path])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: tree shape {tuple(a.shape)} vs "
                             f"module shape {tuple(p.shape)}")
        arrays[path] = a
    with torch.no_grad():
        for path, p in params.items():
            p.copy_(torch.from_numpy(np.array(arrays[path])).to(p.dtype))
    return module
