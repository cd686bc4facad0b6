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
state leaves of the ported modules besides a static int8 layer's
``x_absmax``; stateless modules give empty dicts). The port keeps them as
persistent buffers of the same names (:func:`load_jax_state`, which then
re-arms a calibrated int8 layer as JAX's ``set_state`` does). An int8
layer's ``weight_q`` (int8), ``w_scale`` and ``bias`` are parameters
like any other.

The JAX optimizer's slots (``ostate``) nest as its method's
``init_state`` makes them: a slot of every parameter (SGD's ``v``, Adam's
``m`` and ``v``, ...) is a tree shaped like ``get_params()``, a frozen
parameter's slot a 0-size array; SGD under a stateful schedule adds its
current rate ``clr``; a ``CompositeOptimMethod`` keys each group's slots
``"g<i>:<name>"`` (the rest ``"default"``), a group's slot a flat dict
keyed by parameter path tuples; the flat update keeps one vector a dtype
(``{"float32": vector}``) over the leaves in JAX's tree order (dict keys
sorted). The port's slots are lists in ``named_parameters()`` order (flat
buffers in first-seen dtype order under the flat update):
:func:`ostate_tree` lays them out as JAX does and :func:`load_jax_ostate`
copies a JAX-laid-out tree into them, so a checkpoint of either package
resumes in the other. Under sparse embedding updates the slots are JAX's
``{"dense": the method's layout with the tables' weights 0-size, "embed":
{table path: the method's slots of the table's weight}}``.
"""

from __future__ import annotations

from typing import Callable

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
    """Copy every leaf of ``tree`` (nested dicts of numpy arrays, or of
    tensors on any device) into the parameter of ``module`` with the same
    path, in place and cast to the parameter's dtype. Raises ``KeyError``
    on a missing or extra key and ``ValueError`` on a shape mismatch,
    before any parameter is written."""
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
    _load(buffers, tree, "state", module)
    for m in module.modules():
        if hasattr(m, "state_loaded"):
            m.state_loaded()
    return module


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
        a = flat[path]
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: tree shape {tuple(a.shape)} vs "
                             f"module shape {tuple(p.shape)}")
        arrays[path] = a
    with torch.no_grad():
        for path, p in params.items():
            a = arrays[path]
            p.copy_(a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.array(a)).to(p.dtype))
    return module


def nest(module: torch.nn.Module, values: dict, kind: str = "params") -> dict:
    """``values`` (dotted path -> leaf) nested as the JAX package nests the
    module's ``get_params()`` (``kind="params"``) or ``get_state()``
    (``"state"``): a dict per child module under its name, the leaves under
    theirs, an empty dict for a module without any."""
    def walk(m, prefix):
        tree = {name: walk(child, f"{prefix}{name}.")
                for name, child in m.named_children()}
        own = (m._parameters if kind == "params" else
               {n: b for n, b in m._buffers.items()
                if n not in m._non_persistent_buffers_set})
        for name, t in own.items():
            if t is not None and prefix + name in values:
                tree[name] = values[prefix + name]
        return tree
    return walk(module, "")


def module_state(module: torch.nn.Module) -> dict:
    """The persistent buffers of ``module`` (JAX's module state) by path."""
    params = {n for n, _ in module.named_parameters()}
    return {n: b for n, b in module.state_dict(keep_vars=True).items()
            if n not in params}


def map_tree(fn: Callable, tree):
    """``fn`` applied to every leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, path=()) -> dict:
    """Path tuple -> leaf of nested dicts (empty dicts vanish)."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)))
    return out


def _flat_update(method) -> bool:
    from bigdl_tpu_torch.kernels.fused_update import FlatParamUpdate
    return isinstance(method, FlatParamUpdate)


def _sparse_update(method) -> bool:
    from bigdl_tpu_torch.parallel.embedding import SparseEmbeddingUpdate
    return isinstance(method, SparseEmbeddingUpdate)


def _masked(module, trainable) -> list:
    """``(name, parameter or its 0-size stand-in)`` as the method saw them."""
    named = list(module.named_parameters())
    if trainable is None:
        return named
    return [(n, p if t else p.new_empty(0))
            for (n, p), t in zip(named, trainable)]


def _per_leaf(state: dict, names: list, nest_fn) -> dict:
    return {k: nest_fn(dict(zip(names, v))) if isinstance(v, list) else v
            for k, v in state.items()}


def ostate_tree(method, ostate: dict, module: torch.nn.Module,
                trainable=None) -> dict:
    """The port's slots ``ostate`` of ``method`` in the JAX package's
    layout, each leaf a view of the live slot tensor (or SGD's ``clr``, a
    float). Under the flat update the leaves are per parameter here;
    :func:`ostate_host_layout` makes JAX's flat vectors of them."""
    from bigdl_tpu_torch.optim.optim_method import CompositeOptimMethod
    if _sparse_update(method):
        plan = method.plan
        named = dict(module.named_parameters())
        return {"dense": ostate_tree(method.method, ostate["dense"], module,
                                     plan.mask_embed(named, trainable)),
                "embed": {key: {k: v[0] if isinstance(v, list) else v
                                for k, v in slots.items()}
                          for key, slots in ostate["embed"].items()}}
    masked = _masked(module, trainable)
    names = [n for n, _ in masked]
    if isinstance(method, CompositeOptimMethod):
        parts = method._partition(dict(masked))
        return {key: _per_leaf(ostate[key], list(part),
                               lambda d: {tuple(n.split(".")): t
                                          for n, t in d.items()})
                for (key, _), part in zip(method._methods(), parts)}
    if _flat_update(method):
        ostate = _flat_leaf_views(ostate, [p for _, p in masked])
    return _per_leaf(ostate, names, lambda d: nest(module, d))


def _flat_leaf_views(ostate: dict, params: list) -> dict:
    """The flat update's slots as per-parameter views of its buffers (a
    0-size tensor for a frozen parameter)."""
    from bigdl_tpu_torch.kernels.fused_update import _groups
    where = {}
    for g, idx in enumerate(_groups(params).values()):
        off = 0
        for i in idx:
            where[i] = (g, off)
            off += params[i].numel()

    def views(bufs):
        out = []
        for i, p in enumerate(params):
            if i not in where:
                out.append(p.new_empty(0))
                continue
            g, off = where[i]
            out.append(bufs[g][off:off + p.numel()].view(p.shape))
        return out

    return {k: views(v) if isinstance(v, list) else v
            for k, v in ostate["slots"].items()}


def _jax_flat_order(tree: dict) -> list:
    """Leaf paths of a params-shaped tree in JAX's flatten order."""
    return sorted(_leaves(tree), key=lambda path: tuple(map(str, path)))


def ostate_host_layout(method, tree: dict) -> dict:
    """Arrays of :func:`ostate_tree` (host arrays or tensors) in the file's
    layout: unchanged,
    except under the flat update, whose per-parameter slots become JAX's
    one vector a dtype (``{"float32": vector}``) in JAX's leaf order."""
    if not _flat_update(method):
        return tree
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = v
            continue
        leaves = _leaves(v)
        groups: dict = {}
        for path in _jax_flat_order(v):
            a = leaves[path]
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            d = str(a.dtype).replace("torch.", "")
            groups.setdefault(d, []).append(a.reshape(-1))
        out[k] = {d: (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                      else np.concatenate(parts))
                  for d, parts in groups.items()}
    return out


def _from_flat_layout(tree: dict, views: dict) -> dict:
    """JAX's flat-update slots (one vector a dtype) cut back into
    per-parameter arrays shaped like ``views``."""
    out = {}
    for k, v in tree.items():
        like = views.get(k)
        if not isinstance(like, dict):
            out[k] = v
            continue
        leaves = _leaves(like)
        offsets: dict = {}
        flat = {}
        for path in _jax_flat_order(like):
            t = leaves[path]
            d = str(t.dtype).replace("torch.", "")
            off = offsets.get(d, 0)
            vec = np.asarray(v[d]) if d in v else np.zeros(0)
            flat[path] = vec[off:off + t.numel()].reshape(tuple(t.shape))
            offsets[d] = off + t.numel()
        nested: dict = {}
        for path, a in flat.items():
            node = nested
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
        out[k] = nested
    return out


def load_jax_ostate(method, ostate: dict, module: torch.nn.Module,
                    tree: dict, trainable=None) -> None:
    """Copy the slots of a JAX-laid-out ``ostate`` tree (this package's
    checkpoints or the JAX package's) into the live slots ``ostate`` of
    ``method``, which no copy rebinds; SGD's ``clr`` is set. Raises
    ``KeyError`` when the slot paths differ and ``ValueError`` on a shape
    mismatch, before anything is written."""
    views = ostate_tree(method, ostate, module, trainable)
    if _flat_update(method):
        tree = _from_flat_layout(tree, views)
    want, got = _leaves(views), _leaves(tree)
    missing = sorted(map(str, set(want) - set(got)))
    extra = sorted(map(str, set(got) - set(want)))
    if missing or extra:
        raise KeyError(f"optimizer slot paths differ: missing from the tree "
                       f"{missing}, not in the optimizer {extra}")
    for path, t in want.items():
        a = np.asarray(got[path])
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        if tuple(a.shape) != shape:
            raise ValueError(f"slot {path}: tree shape {tuple(a.shape)} vs "
                             f"optimizer shape {shape}")
    with torch.no_grad():
        for path, t in want.items():
            if isinstance(t, torch.Tensor):
                t.copy_(torch.from_numpy(np.array(got[path])).to(t.dtype))
            else:       # a host number (SGD's clr)
                owner = (ostate[path[0]] if len(path) == 2
                         else slots_owner(method, ostate))
                owner[path[-1]] = float(np.asarray(got[path]))


def slots_owner(method, ostate: dict) -> dict:
    """The slots dict that holds the method's own slots and SGD's ``clr``:
    the default group's of a composite, the inner method's under the flat
    update, the dense pass's under sparse embedding updates."""
    from bigdl_tpu_torch.optim.optim_method import CompositeOptimMethod
    if _sparse_update(method):
        return ostate["dense"]
    if isinstance(method, CompositeOptimMethod):
        return ostate["default"]
    if _flat_update(method):
        return ostate["slots"]
    return ostate
