"""Portable, versioned module serialization, in the JAX package's format.

Counterpart of ``bigdl_tpu/utils/serializer.py``, format, name and version
(``bigdl-tpu-module``, 1), so a file written by either package loads in the
other. A file is a ZIP archive of

- ``manifest.json``: ``{"format", "version", "root": <spec>}``, the spec a
  recursive JSON description of the module tree: the registry type name,
  the constructor arguments (recorded by ``RecordsInit``), the children
  and the indices of the parameter and state arrays;
- ``arrays/<id>.npy``: one standard NPY entry per tensor leaf.

Nothing is pickled: loaders look classes up by registered name (the
port's ``nn`` namespace, ``keras.``-prefixed Keras layers, the
regularizers and :func:`register`-ed classes, under JAX's names), and pass
only the arguments that were recorded. A module that appears twice in one
tree (tied weights) is written once plus ``{"shared_ref": iid}`` markers
and loads as one shared instance. A ``Graph`` writes its nodes and edges.

Where the packages differ, the file keeps JAX's spelling:

- callables are JAX's ``_FN_WHITELIST`` names (``jax.nn.relu``, ...),
  mapped to the port's torch functions both ways;
- ``{"__dtype__": name}`` names a torch dtype here;
- the port-only constructor arguments (``generator``, ``dropout_generator``,
  ``device``) are not recorded: a loaded module is built on
  ``load_module``'s ``device`` (the card unless the caller passes the CPU)
  and takes the file's arrays;
- a bf16 leaf is written as numpy writes JAX's (descr ``<V2``, the raw
  bits) and read back as bf16;
- a spec naming a ``tf.*`` or ``caffe.*`` type (the JAX package's model
  importers) raises naming ROADMAP Queue A.6.
"""

from __future__ import annotations

import inspect
import io
import json
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

FORMAT_NAME = "bigdl-tpu-module"
FORMAT_VERSION = 1


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# JAX's whitelisted callables and the port's functions for them; the first
# name of a function is the one written
_FN_TABLE = (
    ("jax.numpy.tanh", torch.tanh), ("jax.numpy.sin", torch.sin),
    ("jax.numpy.cos", torch.cos), ("jax.numpy.exp", torch.exp),
    ("jax.nn.relu", torch.relu), ("jax.nn.sigmoid", torch.sigmoid),
    ("jax.nn.gelu", _gelu_tanh), ("jax.nn.silu", F.silu),
    ("jax.nn.softplus", F.softplus), ("jax.nn.tanh", torch.tanh),
)
_FN_WHITELIST = frozenset(n for n, _ in _FN_TABLE)
_FN_BY_NAME = dict(_FN_TABLE)
_NAME_BY_FN: dict = {}
for _n, _f in _FN_TABLE:
    _NAME_BY_FN.setdefault(_f, _n)

_UNPORTED_PREFIXES = ("tf.", "caffe.")


class SerializationError(Exception):
    pass


# --------------------------------------------------------------------- registry
_REGISTRY: dict | None = None
_PENDING: list = []
_REV: dict | None = None


def _build_registry() -> dict:
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.nn.abstractnn import AbstractModule
    from bigdl_tpu_torch.nn.criterion import AbstractCriterion
    from bigdl_tpu_torch.nn.initialization import InitializationMethod

    reg: dict = {}

    def _scan(namespace, prefix=""):
        for attr in dir(namespace):
            obj = getattr(namespace, attr)
            if isinstance(obj, type) and issubclass(
                    obj, (AbstractModule, AbstractCriterion,
                          InitializationMethod)):
                n = obj.__dict__.get("__serial_name__", obj.__name__)
                reg[prefix + n] = obj

    # the zoo modules that register classes of their own (JAX registers
    # them at their import; the port imports them here so a file names
    # them whatever the caller imported)
    import bigdl_tpu_torch.kernels.conv_bn  # noqa: F401
    import bigdl_tpu_torch.models.maskrcnn.maskrcnn  # noqa: F401
    import bigdl_tpu_torch.models.resnet.resnet  # noqa: F401
    import bigdl_tpu_torch.models.ssd.ssd  # noqa: F401
    import bigdl_tpu_torch.models.transformer.transformer  # noqa: F401
    import bigdl_tpu_torch.models.transformerlm.transformerlm  # noqa: F401
    import bigdl_tpu_torch.parallel.embedding  # noqa: F401

    _scan(nn)
    import bigdl_tpu_torch.nn.keras.layers as klayers
    _scan(klayers, prefix="keras.")
    import bigdl_tpu_torch.optim.regularizer as regmod
    from bigdl_tpu_torch.optim.regularizer import Regularizer
    for attr in dir(regmod):
        obj = getattr(regmod, attr)
        if isinstance(obj, type) and issubclass(obj, Regularizer) \
                and obj is not Regularizer:
            reg[obj.__name__] = obj
    return reg


def _check_collision(reg: dict, n: str, cls: type) -> None:
    old = reg.get(n)
    if old is not None and old is not cls:
        raise SerializationError(
            f"serialization-registry name collision: {n!r} already maps to "
            f"{old.__module__}.{old.__qualname__}; register "
            f"{cls.__module__}.{cls.__qualname__} under an explicit name")


def _registry() -> dict:
    global _REGISTRY, _REV
    if _REGISTRY is None:
        reg = _build_registry()
        for n, c in _PENDING:
            _check_collision(reg, n, c)
            reg[n] = c
        _REGISTRY = reg
        _REV = None
    return _REGISTRY


def register(cls: type, name: str | None = None) -> type:
    """Register an out-of-tree class for portable serialization (under
    ``name``, default its class name)."""
    global _REV
    n = name or cls.__name__
    if _REGISTRY is None:
        for pn, pc in _PENDING:
            if pn == n and pc is not cls:
                raise SerializationError(
                    f"serialization-registry name collision: {n!r} already "
                    f"pending for {pc.__module__}.{pc.__qualname__}")
        if name is not None:
            cls.__serial_name__ = name
        _PENDING.append((n, cls))
        return cls
    _check_collision(_REGISTRY, n, cls)
    if name is not None:
        cls.__serial_name__ = name
    _REGISTRY[n] = cls
    if _REV is not None:
        _REV[cls] = n
    return cls


def _rev_registry() -> dict:
    global _REV
    if _REV is None:
        _REV = {c: n for n, c in _registry().items()}
    return _REV


def _reg_name(cls: type) -> str:
    name = _rev_registry().get(cls)
    if name is not None:
        return name
    raise SerializationError(
        f"{cls.__module__}.{cls.__name__} is not in the serialization "
        f"registry; export it from bigdl_tpu_torch.nn or call "
        f"serializer.register()")


def _lookup(name: str) -> type:
    cls = _registry().get(name)
    if cls is not None:
        return cls
    if name.startswith(_UNPORTED_PREFIXES):
        raise SerializationError(
            f"{name!r} is a module of the JAX package's TensorFlow/Caffe "
            f"importers, not ported yet: ROADMAP Queue A.6")
    raise SerializationError(
        f"unknown module type {name!r}; registry has {len(_registry())} "
        f"entries")


# ----------------------------------------------------------------------- arrays
def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bf16: the raw bits as a 2-byte void, the descr
            # numpy writes for JAX's ml_dtypes bf16 leaves
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(v)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class _Arrays:
    def __init__(self) -> None:
        self.arrays: list = []
        self.seen: dict = {}

    def add(self, arr) -> int:
        self.arrays.append(_to_numpy(arr))
        return len(self.arrays) - 1


# ----------------------------------------------------------------------- encode
def _encode_value(v: Any, ctx: _Arrays, child_ids: dict | None) -> Any:
    from bigdl_tpu_torch.nn.abstractnn import AbstractModule

    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x, ctx, child_ids) for x in v]}
    if isinstance(v, list):
        return [_encode_value(x, ctx, child_ids) for x in v]
    if isinstance(v, dict):
        return {"__map__": {str(k): _encode_value(x, ctx, child_ids)
                            for k, x in v.items()}}
    if isinstance(v, torch.dtype):
        return {"__dtype__": str(v).rsplit(".", 1)[-1]}
    if isinstance(v, np.dtype):
        return {"__dtype__": v.name}
    if isinstance(v, type) and issubclass(v, np.generic):
        return {"__dtype__": np.dtype(v).name}
    if isinstance(v, AbstractModule):
        if child_ids is not None and id(v) in child_ids:
            return {"__child__": child_ids[id(v)]}
        return {"__module__": _module_spec(v, ctx)}
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return {"__array__": ctx.add(v)}
    if hasattr(v, "_init_args"):
        args, kwargs = v._init_args
        return {"__obj__": _reg_name(type(v)),
                "args": [_encode_value(a, ctx, None) for a in args],
                "kwargs": {k: _encode_value(a, ctx, None)
                           for k, a in kwargs.items()}}
    if callable(v):
        name = _NAME_BY_FN.get(v)
        if name is not None:
            return {"__fn__": name}
        raise SerializationError(
            f"cannot serialize callable {v!r}; only JAX's whitelisted "
            f"functions map across ({sorted(_FN_WHITELIST)})")
    raise SerializationError(
        f"cannot serialize constructor arg {v!r} ({type(v)})")


def _module_state(m) -> dict:
    params = {n for n, _ in m.named_parameters()}
    return {n: b for n, b in m.state_dict(keep_vars=True).items()
            if n not in params}


def _common(spec: dict, m) -> dict:
    if m.scale_w != 1.0 or m.scale_b != 1.0:
        spec["scale_w"], spec["scale_b"] = m.scale_w, m.scale_b
    if getattr(m, "_frozen", False):
        spec["frozen"] = True
    return spec


def _module_spec(m, ctx: _Arrays) -> dict:
    from bigdl_tpu_torch.nn.abstractnn import Container
    from bigdl_tpu_torch.nn.graph import Graph

    if id(m) in ctx.seen:
        return {"shared_ref": ctx.seen[id(m)]}
    iid = len(ctx.seen)
    ctx.seen[id(m)] = iid

    if isinstance(m, Graph):
        spec = _graph_spec(m, ctx)
        spec["iid"] = iid
        return _common(spec, m)

    spec: dict = {"type": _reg_name(type(m)), "name": m.name, "iid": iid}
    _common(spec, m)
    args, kwargs = getattr(m, "_init_args", ((), {}))

    if isinstance(m, Container):
        children = list(m._modules.values())
        child_ids: dict = {}
        for i, c in enumerate(children):
            child_ids.setdefault(id(c), i)
        spec["children"] = [_module_spec(c, ctx) for c in children]
        enc_args = [_encode_value(a, ctx, child_ids) for a in args]
        enc_kwargs = {k: _encode_value(a, ctx, child_ids)
                      for k, a in kwargs.items()}
        referenced: set = set()

        def _walk(x):
            if isinstance(x, dict):
                if "__child__" in x:
                    referenced.add(x["__child__"])
                for v in x.values():
                    _walk(v)
            elif isinstance(x, list):
                for v in x:
                    _walk(v)

        _walk(enc_args), _walk(enc_kwargs)
        spec["added_children"] = [i for i in range(len(children))
                                  if i not in referenced]
        spec["config"] = {"args": enc_args, "kwargs": enc_kwargs}
    else:
        spec["config"] = {
            "args": [_encode_value(a, ctx, None) for a in args],
            "kwargs": {k: _encode_value(a, ctx, None)
                       for k, a in kwargs.items()},
        }
        params = dict(m.named_parameters())
        if params:
            spec["params"] = {k: ctx.add(v) for k, v in params.items()}
        state = _module_state(m)
        if state:
            spec["state"] = {k: ctx.add(v) for k, v in state.items()}
    return spec


def _graph_spec(g, ctx: _Arrays) -> dict:
    nodes = []
    for n in g.sorted_nodes:
        nodes.append({
            "id": n.id,
            "prev": [p.id for p in n.prev_nodes],
            "module": None if n.module is None else _module_spec(n.module, ctx),
        })
    return {
        "type": _reg_name(type(g)),
        "name": g.name,
        "graph": {
            "nodes": nodes,
            "inputs": [n.id for n in g.input_nodes],
            "outputs": [n.id for n in g.output_nodes],
        },
    }


# ----------------------------------------------------------------------- decode
def _decode_value(v: Any, arrays: list, children: list | None,
                  cache: dict) -> Any:
    if isinstance(v, list):
        return [_decode_value(x, arrays, children, cache) for x in v]
    if not isinstance(v, dict):
        return v
    if "__tuple__" in v:
        return tuple(_decode_value(x, arrays, children, cache)
                     for x in v["__tuple__"])
    if "__map__" in v:
        return {k: _decode_value(x, arrays, children, cache)
                for k, x in v["__map__"].items()}
    if "__dtype__" in v:
        dt = getattr(torch, v["__dtype__"], None)
        if not isinstance(dt, torch.dtype):
            raise SerializationError(f"unknown dtype {v['__dtype__']!r}")
        return dt
    if "__array__" in v:
        return arrays[v["__array__"]]
    if "__child__" in v:
        return children[v["__child__"]]
    if "__module__" in v:
        return _build_module(v["__module__"], arrays, cache)
    if "__fn__" in v:
        name = v["__fn__"]
        if name not in _FN_WHITELIST:
            raise SerializationError(f"function {name!r} not whitelisted")
        return _FN_BY_NAME[name]
    if "__obj__" in v:
        cls = _lookup(v["__obj__"])
        args = [_decode_value(a, arrays, None, cache)
                for a in v.get("args", [])]
        kwargs = {k: _decode_value(a, arrays, None, cache)
                  for k, a in v.get("kwargs", {}).items()}
        return cls(*args, **_with_device(cls, kwargs, cache))
    return {k: _decode_value(x, arrays, children, cache) for k, x in v.items()}


def _with_device(cls, kwargs: dict, cache: dict) -> dict:
    """``kwargs`` plus the load's ``device`` for a constructor that takes
    one (the port's modules default to the card)."""
    try:
        takes = "device" in inspect.signature(cls).parameters
    except (TypeError, ValueError):
        takes = False
    return dict(kwargs, device=cache["__device__"]) if takes else kwargs


def _assign(m, kind: str, path: str, arr: np.ndarray) -> None:
    """Set parameter or buffer ``path`` of ``m`` to ``arr`` (its dtype)."""
    *parents, leaf = path.split(".")
    owner = m
    for p in parents:
        owner = getattr(owner, p)
    table = owner._parameters if kind == "params" else owner._buffers
    if leaf not in table or table[leaf] is None:
        raise SerializationError(
            f"{type(m).__name__} has no {kind[:-1] if kind == 'params' else kind} "
            f"{path!r}")
    cur = table[leaf]
    t = _to_tensor(arr).to(cur.device)
    if tuple(t.shape) != tuple(cur.shape):
        raise SerializationError(
            f"{type(m).__name__}.{path}: file shape {tuple(t.shape)} vs "
            f"module shape {tuple(cur.shape)}")
    with torch.no_grad():
        if kind == "params":
            cur.data = t
        else:
            table[leaf] = t


def _copy_tree(dst, src) -> None:
    """Copy ``src``'s parameters and buffers into ``dst`` (same paths)."""
    if dst is src:
        return
    sd = src.state_dict()
    with torch.no_grad():
        for k, t in dst.state_dict(keep_vars=True).items():
            t.data = sd[k].detach().clone().to(t.device)


def _build_module(spec: dict, arrays: list, cache: dict):
    if "shared_ref" in spec:
        return cache[spec["shared_ref"]]

    cls = _lookup(spec["type"])
    if "graph" in spec:
        m = _build_graph(cls, spec, arrays, cache)
    else:
        children = [_build_module(s, arrays, cache)
                    for s in spec.get("children", [])]
        cfg = spec.get("config", {})
        args = [_decode_value(a, arrays, children, cache)
                for a in cfg.get("args", [])]
        kwargs = {k: _decode_value(a, arrays, children, cache)
                  for k, a in cfg.get("kwargs", {}).items()}
        m = cls(*args, **_with_device(cls, kwargs, cache))
        for i in spec.get("added_children", []):
            if len(m._modules) >= len(children):
                break   # the constructor made its children (a clone)
            m.add(children[i])
        if children and len(m._modules) == len(children):
            for mine, theirs in zip(m._modules.values(), children):
                _copy_tree(mine, theirs)
        for kind in ("params", "state"):
            for k, i in spec.get(kind, {}).items():
                _assign(m, kind, k, arrays[i])
        m.name = spec.get("name", m.name)
    m.scale_w = spec.get("scale_w", 1.0)
    m.scale_b = spec.get("scale_b", 1.0)
    if spec.get("frozen"):
        m._frozen = True
    if "iid" in spec:
        cache[spec["iid"]] = m
    return m


def _build_graph(cls, spec: dict, arrays: list, cache: dict):
    from bigdl_tpu_torch.nn.graph import ModuleNode

    g = spec["graph"]
    node_map: dict = {}
    for ns in g["nodes"]:
        module = None if ns["module"] is None else _build_module(
            ns["module"], arrays, cache)
        node_map[ns["id"]] = ModuleNode(module,
                                        [node_map[p] for p in ns["prev"]])
    graph = cls([node_map[i] for i in g["inputs"]],
                [node_map[i] for i in g["outputs"]])
    graph.name = spec.get("name", graph.name)
    return graph


# -------------------------------------------------------------------- save/load
def save_module(module, path: str, overwrite: bool = True) -> None:
    """Write ``module`` in the portable format (atomic: a temporary file
    renamed over ``path``)."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (pass overwrite=True)")
    ctx = _Arrays()
    root = _module_spec(module, ctx)
    manifest = {"format": FORMAT_NAME, "version": FORMAT_VERSION, "root": root}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("manifest.json", json.dumps(manifest))
            for i, arr in enumerate(ctx.arrays):
                buf = io.BytesIO()
                np.lib.format.write_array(buf, np.ascontiguousarray(arr))
                zf.writestr(f"arrays/{i}.npy", buf.getvalue())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def is_portable_file(path: str) -> bool:
    return zipfile.is_zipfile(path)


def load_module(path: str, device=None):
    """Read a portable file (either package's) into the port's modules, built
    on ``device`` (default the card, as every entry point of the port)."""
    from bigdl_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        if manifest.get("format") != FORMAT_NAME:
            raise SerializationError(
                f"{path}: not a {FORMAT_NAME} file "
                f"(format={manifest.get('format')!r})")
        if manifest.get("version", 0) > FORMAT_VERSION:
            raise SerializationError(
                f"{path}: written by a newer format version "
                f"({manifest['version']} > {FORMAT_VERSION})")
        n = len([e for e in zf.namelist()
                 if re.fullmatch(r"arrays/\d+\.npy", e)])
        arrays = [np.lib.format.read_array(io.BytesIO(zf.read(f"arrays/{i}.npy")))
                  for i in range(n)]
    return _build_module(manifest["root"], arrays, {"__device__": device}
                         ).to(device)
