"""Elastic (sharded, topology-portable) checkpoints.

Counterpart of ``bigdl_tpu/utils/elastic_ckpt.py``, with its names and its
files, so a version written by either package resumes in the other. Each
rank writes only the leaf blocks it owns; a manifest commits the version
last; a resume assembles every leaf whole and re-places it on whatever mesh
is alive. One directory a version::

    <ckpt_path>/elastic.<neval>/
        shard-0.data     # rank 0's blocks   (CRC32 + fsync, utils/file.py)
        shard-1.data     # rank 1's blocks
        manifest.pkl     # written last, by atomic rename: the version
                         # exists iff this file does

Each ``shard-<rank>.data`` holds ``{leaf_key: [(block_index, ndarray),
...]}`` where ``block_index`` is the canonical ``((start, stop), ...)`` of a
block. A leaf key is JAX's ``f"{i}{keystr(path)}"`` over the tree JAX
checkpoints (``{"params", "mstate", "ostate"}`` in JAX's layout):
:func:`_flatten_with_path` walks a tree as ``jax.tree_util`` does (dict keys
sorted, ``None`` an empty node).

JAX reads a leaf's blocks off its ``jax.Array`` sharding; the port's rank
holds one part of each leaf, described by :class:`PlacedLeaf`: the part
(``data``), the whole leaf's ``shape``, JAX's ``spec`` of it over the port's
:class:`~bigdl_tpu_torch.utils.engine.Mesh`, and, for a pipeline stage's
leaves, the ranks whose copy is the trained one (``holders``). A plain
tensor is a replicated leaf. Ownership dedups replication as in JAX: the
owner of a block is the lowest rank holding it, so a replicated leaf is
written once and a ZeRO or tensor-parallel block once a slice.

The manifest holds the tree's skeleton with :class:`_LeafRef` markers in
place of the array leaves. It pickles the marker under JAX's name,
``bigdl_tpu.utils.elastic_ckpt._LeafRef``, without importing that module
(:class:`_ManifestPickler`), and ``utils/file.py`` reads that one name back
as this module's class, so neither package needs the other to read it.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.file import CheckpointCorruptError

logger = logging.getLogger(__name__)

MANIFEST = "manifest.pkl"
_VERSION_RE = re.compile(r"^elastic\.(\d+)$")
_SHARD_RE = re.compile(r"^shard-(\d+)\.data$")

#: the marker's name in the files (JAX's module)
_JAX_LEAFREF = b"bigdl_tpu.utils.elastic_ckpt\n_LeafRef\n"


class ElasticCheckpointError(CheckpointCorruptError):
    """An elastic version directory failed its integrity or coverage checks
    (missing blocks, a corrupt shard, a bad manifest). A subclass of
    :class:`CheckpointCorruptError`, so one except clause quarantines
    both."""


class _LeafRef:
    """Skeleton marker standing in for an array leaf, keyed into the shard
    files' block maps."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __repr__(self):
        return f"_LeafRef({self.key!r})"


class _SpecLeaf:
    """Opaque per-leaf spec holder (a tree of these zips against the data
    tree without the spec tuples being walked as containers)."""

    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


class _ManifestPickler(pickle._Pickler):
    """The pure-Python pickler, writing :class:`_LeafRef` as JAX's global
    (``pickle.Pickler`` would import ``bigdl_tpu`` to check the name)."""

    def save_global(self, obj, name=None):
        if obj is _LeafRef:
            self.write(pickle.GLOBAL + _JAX_LEAFREF)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class PlacedLeaf:
    """A leaf as this rank holds it: ``data`` (its block, or the whole of a
    replicated leaf), the whole leaf's ``shape``, JAX's ``spec`` (a tuple of
    axis names, ``None`` per dim not split) over ``mesh``, and ``holders``:
    the ranks whose copy counts (None: every rank)."""

    __slots__ = ("data", "shape", "spec", "mesh", "holders")

    def __init__(self, data, shape, spec=(), mesh=None, holders=None):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec or ())
        self.mesh = mesh
        self.holders = None if holders is None else frozenset(holders)

    def index_of(self, rank: int) -> tuple:
        """The slices of the whole leaf that ``rank`` holds."""
        mesh = self.mesh
        coords = {} if mesh is None else dict(zip(
            mesh.axis_names,
            (int(c) for c in np.argwhere(mesh.devices == rank)[0])))
        out = []
        for dim, size in enumerate(self.shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            if entry is None:
                out.append(slice(0, size))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, c = 1, 0
            for a in axes:
                k = mesh.shape[a]
                n, c = n * k, c * k + coords[a]
            step = size // n
            out.append(slice(c * step, (c + 1) * step))
        return tuple(out)

    def devices_indices_map(self) -> dict:
        """``{rank: slices}`` over the ranks holding a valid copy (JAX's
        ``sharding.devices_indices_map``)."""
        ranks = [0] if self.mesh is None else \
            [int(r) for r in self.mesh.devices.reshape(-1)]
        return {r: self.index_of(r) for r in ranks
                if self.holders is None or r in self.holders}


# ------------------------------------------------------------------ paths
def version_dirname(version: int) -> str:
    return f"elastic.{int(version)}"


def version_of(name: str) -> Optional[int]:
    m = _VERSION_RE.match(name)
    return int(m.group(1)) if m else None


def shard_path(dirpath: str, process_index: int) -> str:
    return os.path.join(dirpath, f"shard-{int(process_index)}.data")


def list_versions(path: str) -> dict:
    """``{version: dirname}`` for every ``elastic.<n>`` directory under
    ``path`` (quarantined ``*.corrupt`` directories excluded)."""
    if not os.path.isdir(path):
        return {}
    out = {}
    for name in os.listdir(path):
        v = version_of(name)
        if v is not None and os.path.isdir(os.path.join(path, name)):
            out[v] = name
    return out


def complete_versions(path: str) -> list:
    """Versions whose manifest committed, ascending. Only these exist as
    checkpoints; any other is a write in flight or abandoned."""
    return sorted(v for v, name in list_versions(path).items()
                  if os.path.exists(os.path.join(path, name, MANIFEST)))


def partial_versions(path: str) -> list:
    """Names of version directories WITHOUT a committed manifest."""
    return [name for v, name in sorted(list_versions(path).items())
            if not os.path.exists(os.path.join(path, name, MANIFEST))]


def quarantine(path: str, dirname: str) -> str:
    """Rename a bad version directory aside as ``<dir>.corrupt`` (kept,
    never tried again)."""
    full = os.path.join(path, dirname)
    target = full + ".corrupt"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{full}.corrupt.{n}"
    os.rename(full, target)
    return target


# -------------------------------------------------------------- snapshot
def _canonical_index(idx, shape) -> tuple:
    """A block's index as ``((start, stop), ...)``: hashable and
    unambiguous."""
    return tuple(sl.indices(dim)[:2] for sl, dim in zip(idx, shape))


def _block_volume(cidx) -> int:
    v = 1
    for start, stop in cidx:
        v *= max(0, stop - start)
    return v


def _leaf_volume(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, PlacedLeaf))


def _placed(leaf) -> PlacedLeaf:
    return leaf if isinstance(leaf, PlacedLeaf) else \
        PlacedLeaf(leaf, tuple(leaf.shape))


def _owned_blocks(leaf, process_index: int):
    """Canonical indices of the blocks ``process_index`` must persist: for
    each distinct block, the owner is the lowest rank holding it."""
    leaf = _placed(leaf)
    shape = leaf.shape
    owners: dict = {}
    for rank, idx in leaf.devices_indices_map().items():
        c = _canonical_index(idx, shape)
        prev = owners.get(c)
        if prev is None or rank < prev:
            owners[c] = rank
    return {c for c, p in owners.items() if p == int(process_index)}


def _flatten_with_path(tree, path: str = ""):
    """``(keystr, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and notation: dicts by sorted key (``['k']``), lists and tuples
    by position (``[0]``), ``None`` an empty node."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _map_with_path(fn, tree, path: str = ""):
    """``fn(keystr, leaf)`` over the leaves, paths as
    :func:`_flatten_with_path` writes them."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    try:
        return np.dtype(str(t.dtype).replace("torch.", ""))
    except TypeError:
        raise ValueError(f"an elastic checkpoint holds numpy dtypes; a "
                         f"{t.dtype} leaf has none") from None


def snapshot_tree(tree, process_index: int = 0):
    """Device-to-host snapshot of the blocks ``process_index`` owns.

    Returns ``(skeleton, leaves, blocks)``: ``skeleton`` the same containers
    with array leaves (tensors, :class:`PlacedLeaf`) replaced by
    :class:`_LeafRef` and other leaves inline; ``leaves`` ``{key: {"shape",
    "dtype", "spec"}}`` for every array leaf; ``blocks`` ``{key:
    {canonical_index: ndarray}}``, the owned ones only. The copies off the
    card land in page-locked buffers after the work already queued, and the
    stream is synchronised once."""
    pairs = list(_flatten_with_path(tree))
    leaves: dict = {}
    blocks: dict = {}
    pending = []
    for i, (path, leaf) in enumerate(pairs):
        if not _is_array(leaf):
            continue
        key = f"{i}{path}"
        leaf = _placed(leaf)
        data = leaf.data.detach()
        leaves[key] = {"shape": leaf.shape, "dtype": _np_dtype(data),
                       "spec": leaf.spec}
        mine: dict = {}
        rank = int(process_index)
        if leaf.holders is None or rank in leaf.holders:
            c = _canonical_index(leaf.index_of(rank), leaf.shape)
            if c in _owned_blocks(leaf, rank):
                if data.is_cuda:
                    buf = torch.empty(data.shape, dtype=data.dtype,
                                      pin_memory=True)
                    buf.copy_(data, non_blocking=True)
                    pending.append(buf)
                else:
                    buf = data.clone()
                mine[c] = buf
        blocks[key] = mine
    if pending:
        torch.cuda.current_stream().synchronize()
    blocks = {k: {c: t.reshape(_shape_of(c)).numpy() for c, t in v.items()}
              for k, v in blocks.items()}
    index = {path: i for i, (path, _) in enumerate(pairs)}
    skeleton = _map_with_path(
        lambda path, leaf: _LeafRef(f"{index[path]}{path}")
        if _is_array(leaf) else leaf, tree)
    return skeleton, leaves, blocks


def _shape_of(cidx) -> tuple:
    return tuple(b - a for a, b in cidx)


# ----------------------------------------------------------------- write
def write_shard(dirpath: str, process_index: int, blocks: dict) -> int:
    """Persist this rank's blocks as ``shard-<rank>.data`` (CRC32 footer,
    fsync before the rename). Returns the bytes written (``ckpt/bytes``)."""
    payload = {"format": 1, "process_index": int(process_index),
               "blocks": {k: sorted(v.items()) for k, v in blocks.items()}}
    data = ckpt_file.dumps(payload)
    ckpt_file.save_bytes(data, shard_path(dirpath, process_index))
    return len(data)


def _covered(leaves: dict, seen: dict) -> bool:
    for key, info in leaves.items():
        vol = sum(_block_volume(c) for c in seen.get(key, ()))
        if vol != _leaf_volume(info["shape"]):
            return False
    return True


def commit_manifest(dirpath: str, skeleton, leaves: dict, mesh: Optional[dict],
                    meta: dict, timeout: float = 60.0,
                    poll: float = 0.05) -> bool:
    """Commit the version once the union of durable, CRC-valid shard files
    covers every leaf. No collective: the writer (rank 0) polls the shared
    directory, so a version whose blocks a dead rank never wrote never
    commits, and loaders fall back to the previous one. Every shard, the
    writer's own too, is read back and its CRC checked. The manifest lands
    by atomic rename, the version's last file. True iff committed within
    ``timeout`` seconds."""
    deadline = time.monotonic() + float(timeout)
    validated: dict = {}   # shard name -> {leaf_key: set(canonical_index)}
    shard_names: list = []
    while True:
        try:
            names = sorted(n for n in os.listdir(dirpath) if _SHARD_RE.match(n))
        except OSError:
            names = []
        for name in names:
            if name in validated:
                continue
            try:
                payload = ckpt_file.load(os.path.join(dirpath, name))
                validated[name] = {k: {c for c, _ in bl}
                                   for k, bl in payload["blocks"].items()}
            except (CheckpointCorruptError, OSError, KeyError):
                continue  # mid-rename or torn: probed again next round
        seen: dict = {}
        for cover in validated.values():
            for k, cs in cover.items():
                seen.setdefault(k, set()).update(cs)
        shard_names = sorted(validated)
        if _covered(leaves, seen):
            break
        if time.monotonic() > deadline:
            logger.error(
                "elastic checkpoint %s: shard coverage incomplete after "
                "%.1fs (have %s): manifest NOT committed", dirpath, timeout,
                shard_names)
            return False
        time.sleep(poll)
    manifest = {"format": 1, "skeleton": skeleton, "leaves": leaves,
                "mesh": mesh, "meta": meta, "shards": shard_names}
    ckpt_file.save_bytes(ckpt_file.dumps(manifest, _ManifestPickler),
                         os.path.join(dirpath, MANIFEST))
    logger.info("elastic checkpoint committed: %s (%d shard files)",
                dirpath, len(shard_names))
    return True


# ------------------------------------------------------------------ load
def load_manifest(dirpath: str) -> dict:
    manifest = ckpt_file.load(os.path.join(dirpath, MANIFEST))
    if not isinstance(manifest, dict) or "leaves" not in manifest \
            or "skeleton" not in manifest:
        raise ElasticCheckpointError(
            dirpath, f"{dirpath}: manifest is not an elastic manifest")
    return manifest


def assemble(dirpath: str, manifest: Optional[dict] = None):
    """Rebuild the whole host tree of one version from its shard files.

    Returns ``(tree, spec_tree, manifest)``: ``tree`` with numpy leaves
    bitwise what was saved, ``spec_tree`` mirroring it with
    :class:`_SpecLeaf` holders for :func:`place_tree`. Raises
    :class:`ElasticCheckpointError` on a corrupt or missing shard or a
    coverage gap, so a caller can quarantine the version and fall back."""
    if manifest is None:
        manifest = load_manifest(dirpath)
    leaves = manifest["leaves"]
    data: dict = {}
    seen: dict = {k: set() for k in leaves}
    for name in manifest["shards"]:
        full = os.path.join(dirpath, name)
        try:
            payload = ckpt_file.load(full)
        except OSError as e:
            raise ElasticCheckpointError(
                full, f"{full}: manifest-listed shard unreadable: {e}") from e
        for key, blist in payload["blocks"].items():
            info = leaves.get(key)
            if info is None:
                continue
            out = data.get(key)
            if out is None:
                out = data[key] = np.empty(info["shape"],
                                           dtype=info["dtype"])
            for cidx, arr in blist:
                if cidx in seen[key]:
                    continue
                out[tuple(slice(a, b) for a, b in cidx)] = arr
                seen[key].add(cidx)
    missing = [k for k, info in leaves.items()
               if sum(_block_volume(c) for c in seen[k])
               != _leaf_volume(info["shape"])]
    if missing:
        raise ElasticCheckpointError(
            dirpath,
            f"{dirpath}: shard files do not cover leaves {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}")

    skeleton = manifest["skeleton"]
    tree = _map_with_path(
        lambda _, x: data[x.key] if isinstance(x, _LeafRef) else x, skeleton)
    spec_tree = _map_with_path(
        lambda _, x: _SpecLeaf(leaves[x.key]["spec"])
        if isinstance(x, _LeafRef) else _SpecLeaf(None), skeleton)
    return tree, spec_tree, manifest


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    if tree is None:
        return None
    return fn(tree, other)


def place_tree(tree, spec_tree, mesh):
    """Re-place assembled leaves under ``mesh``'s rules: each recorded spec
    adapted (``parallel.sharding.adapt_spec``: axes the mesh lacks and
    splits that do not divide degrade to replication), and each leaf
    becomes this rank's block of it under the adapted spec, a CPU tensor.
    Inline (non-array) leaves pass through untouched."""
    from bigdl_tpu_torch.parallel.sharding import adapt_spec

    def _place(x, s):
        if not isinstance(s, _SpecLeaf) or not isinstance(x, np.ndarray):
            return x
        spec = tuple(adapt_spec(s.spec, mesh, np.shape(x)))
        idx = PlacedLeaf(None, np.shape(x), spec, mesh).index_of(mesh.rank)
        return torch.from_numpy(np.ascontiguousarray(x[idx]))

    return _zip_map(_place, tree, spec_tree)


def mesh_info(mesh, process_count: int = 1) -> Optional[dict]:
    """The mesh's identity recorded in the manifest (what a resume compares
    to detect a change of topology)."""
    if mesh is None:
        return {"axes": None, "shape": None,
                "process_count": int(process_count)}
    return {"axes": tuple(mesh.axis_names),
            "shape": tuple(int(s) for s in mesh.devices.shape),
            "process_count": int(process_count)}


# ------------------------------------------------------- version agreement
def agree_version(path: str, process_index: int, process_count: int,
                  timeout: float = 60.0, poll: float = 0.05,
                  barrier=None) -> Optional[int]:
    """Agreement of the ranks on WHICH version to resume: each publishes
    its newest complete version as a claim file in the shared directory,
    waits for all of them, and takes the smallest: the newest version every
    rank sees. A quorum that never forms (a dead peer) times out to the
    local view, the shrunk-fleet resume. Claims are written on entry and
    removed on exit; no save runs during a load (the trainer joins its
    writer first). ``barrier`` (the trainer's collective, when its ranks
    share a live process group) is passed once the quorum formed, before
    any claim is removed, so that no rank still polling loses one."""
    local = complete_versions(path)
    mine = local[-1] if local else None
    if process_count <= 1:
        return mine
    os.makedirs(path, exist_ok=True)
    claim = os.path.join(path, f"resume-claim.{int(process_index)}")
    ckpt_file.save({"version": mine}, claim)
    deadline = time.monotonic() + float(timeout)
    agreed = mine
    while True:
        claims = {}
        for i in range(int(process_count)):
            p = os.path.join(path, f"resume-claim.{i}")
            try:
                claims[i] = ckpt_file.load(p)["version"]
            except (OSError, CheckpointCorruptError, KeyError, TypeError):
                pass
        if len(claims) == int(process_count):
            versions = [v for v in claims.values() if v is not None]
            agreed = min(versions) if len(versions) == len(claims) else None
            break
        if time.monotonic() > deadline:
            logger.warning(
                "elastic resume: version quorum incomplete after %.1fs "
                "(%d/%d claims): resuming from the local view (version %s)",
                timeout, len(claims), process_count, mine)
            break
        time.sleep(poll)
    if barrier is not None:
        barrier()
    try:
        os.remove(claim)
    except OSError:
        pass
    return agreed


def remove_version(path: str, dirname: str) -> None:
    """Delete one COMPLETE version directory, manifest first: a crash
    mid-prune never leaves a manifest naming missing shards."""
    full = os.path.join(path, dirname)
    try:
        os.remove(os.path.join(full, MANIFEST))
    except OSError:
        pass
    shutil.rmtree(full, ignore_errors=True)
    for name in os.listdir(path) if os.path.isdir(path) else ():
        if name.startswith(dirname + ".corrupt"):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)
