"""Move weights from the JAX package into the port by path.

The JAX ``model.get_params()`` tree nests dicts by container child index
(``"0"``, ``"1"``, ...) down to the leaf key names (``weight``,
``qkv_weight``, ``pos``, ...; grouped-query attention's ``q_weight``,
``kv_weight`` and their biases, RMSNorm's and ``FusedLMHead``'s
``weight``/``bias``, the ``"0"`` level a ``Remat`` block adds). The port
registers its parameters under the same names in the same tree, so a
leaf's dotted path in the JAX tree is the name of the port's parameter.
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
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing from the tree "
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
