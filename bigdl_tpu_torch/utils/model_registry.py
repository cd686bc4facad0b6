"""Versioned model-artifact registry: the handoff from training to serving.

Counterpart of ``bigdl_tpu/utils/model_registry.py``, with its on-disk
layout and payload, so a version written by either package resolves in the
other. One directory a version::

    <registry_dir>/
        v0003/
            artifact.pkl   # CRC32-footered (utils/file.py): the payload
            status.pkl     # rewritten atomically at every transition

The payload is a plain dict::

    {"kind": "full",            # or "lora"
     "params": <host tree>,     # full: the params tree as JAX lays out
                                # get_params(), numpy leaves
     "delta": {path: ndarray},  # lora: only the adapter leaves
     "base_version": int|None,  # lora: the full version it patches
     "meta": {...}}             # provenance (source, neval, ...)

:meth:`ModelRegistry.resolve_params` overlays a LoRA artifact's leaves
onto its base's tree, which an engine serving the adapted model swaps in
(:func:`lora_delta` extracts them; the base is a full artifact of the
adapted model, adapters included). The status goes ``candidate`` ->
``promoted`` -> (``rolled_back`` | superseded), or ``candidate`` ->
``rejected``. Keep-last-N pruning (``BIGDL_REGISTRY_KEEP``, default 4)
never removes a ``promoted`` version, the newest, or a LoRA base a
surviving artifact names.

The trainer publishes each checkpoint it writes
(``Optimizer.set_model_registry`` / ``BIGDL_REGISTRY_DIR``), on its writer
thread; a registry failure is logged, never raised into training. An
elastic version is published by ``register_from_elastic``, which
assembles its ``params`` from the version's files (what a resume loads).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.file import CheckpointCorruptError
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.model_registry")

ARTIFACT = "artifact.pkl"
STATUS = "status.pkl"
_VERSION_RE = re.compile(r"^v(\d+)$")

#: legal status transitions — anything else is a programming error
STATUSES = ("candidate", "promoted", "rejected", "rolled_back")


def version_dirname(version: int) -> str:
    return f"v{int(version):04d}"


# ------------------------------------------------------------- tree helpers

def flatten_params(tree, prefix: str = "") -> dict:
    """Nested params dict → ``{"/".join(path): leaf}`` (arrays only)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def _set_path(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        if not isinstance(node.get(k), dict):
            raise KeyError(path)
        node = node[k]
    if keys[-1] not in node:
        raise KeyError(path)
    node[keys[-1]] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


_ADAPTER_LEAF = re.compile(r"^lora_(?:.+_)?[ab]$")


def lora_delta(params) -> dict:
    """Extract every adapter leaf from a full params tree, the payload of a
    LoRA-only artifact: ``LoRALinear``'s ``lora_a``/``lora_b`` and
    ``MultiHeadAttention``'s ``lora_<weight>_a``/``_b``. (JAX's rule keeps
    the first two only, so its artifact of an adapted LM drops the
    attention's adapters: ROADMAP Queue C.)"""
    flat = flatten_params(_to_host(params))
    return {p: v for p, v in flat.items()
            if _ADAPTER_LEAF.match(p.rsplit("/", 1)[-1])}


class ModelRegistry:
    """Filesystem-backed versioned weight registry. Thread-safe: the
    checkpoint writer thread publishes while the promotion controller
    reads."""

    def __init__(self, path: str, keep: Optional[int] = None):
        self.path = path
        if keep is None:
            keep = int(os.environ.get("BIGDL_REGISTRY_KEEP", "4"))
        self.keep = int(keep)
        self._lock = threading.RLock()
        os.makedirs(path, exist_ok=True)

    # ------------------------------------------------------------ listing
    def versions(self) -> list:
        """Sorted versions that have a durable artifact file."""
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return []
        out = []
        for name in names:
            m = _VERSION_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.path, name, ARTIFACT)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self, status: Optional[str] = None) -> Optional[int]:
        """Newest version, optionally filtered by status."""
        for v in reversed(self.versions()):
            if status is None or self.status(v).get("status") == status:
                return v
        return None

    def _dir(self, version: int) -> str:
        return os.path.join(self.path, version_dirname(version))

    # --------------------------------------------------------- publication
    def publish(self, params, version: Optional[int] = None,
                kind: str = "full", delta: Optional[dict] = None,
                base_version: Optional[int] = None,
                meta: Optional[dict] = None) -> int:
        """Write one artifact as ``candidate`` and return its version.

        ``kind="full"`` stores the complete host-side params tree;
        ``kind="lora"`` stores only ``delta`` (adapter leaves) against
        ``base_version`` and ignores ``params``.
        """
        if kind not in ("full", "lora"):
            raise ValueError(f"unknown artifact kind {kind!r}")
        if kind == "lora":
            if delta is None or base_version is None:
                raise ValueError(
                    "lora artifact needs delta= and base_version=")
        with self._lock:
            if version is None:
                have = self.versions()
                version = (have[-1] + 1) if have else 1
            version = int(version)
            d = self._dir(version)
            if os.path.exists(os.path.join(d, ARTIFACT)):
                raise ValueError(f"registry version {version} already exists")
            payload = {"kind": kind, "meta": dict(meta or {})}
            if kind == "full":
                payload["params"] = _to_host(params)
                payload["delta"] = None
                payload["base_version"] = None
            else:
                payload["params"] = None
                payload["delta"] = {p: np.asarray(a)
                                    for p, a in delta.items()}
                payload["base_version"] = int(base_version)
            os.makedirs(d, exist_ok=True)
            # status first, artifact last: a version "exists" iff the
            # artifact file does, so a crash in between leaves nothing
            # visible (the artifact is written last)
            ckpt_file.save({"version": version, "status": "candidate",
                            "kind": kind, "created_t": time.time(),
                            "history": []},
                           os.path.join(d, STATUS))
            ckpt_file.save(payload, os.path.join(d, ARTIFACT))
            events.record("registry_published", version=version,
                          artifact=kind)
            logger.info("registry: published v%d (%s) at %s",
                        version, kind, d)
            self.prune()
            return version

    def publish_lora(self, delta: dict, base_version: int,
                     version: Optional[int] = None,
                     meta: Optional[dict] = None) -> int:
        return self.publish(None, version=version, kind="lora", delta=delta,
                            base_version=base_version, meta=meta)

    def register_from_elastic(self, ckpt_path: str,
                              version: Optional[int] = None,
                              meta: Optional[dict] = None) -> Optional[int]:
        """Assemble a manifest-committed elastic checkpoint version
        (``utils/elastic_ckpt.py``) and publish its ``params`` subtree.
        ``version=None`` takes the newest complete one; returns the registry
        version, or None when there is nothing new to publish."""
        from bigdl_tpu_torch.utils import elastic_ckpt
        have = elastic_ckpt.complete_versions(ckpt_path)
        if not have:
            return None
        if version is None:
            version = have[-1]
        if version not in have:
            raise ValueError(
                f"elastic version {version} not manifest-complete "
                f"in {ckpt_path}")
        with self._lock:
            if os.path.exists(os.path.join(self._dir(version), ARTIFACT)):
                return None  # already registered
            dirpath = os.path.join(ckpt_path,
                                   elastic_ckpt.version_dirname(version))
            tree, _spec, manifest = elastic_ckpt.assemble(dirpath)
            params = tree.get("params")
            if params is None:
                raise CheckpointCorruptError(
                    dirpath, "elastic checkpoint has no 'params' subtree")
            m = {"source": "elastic", "ckpt_dir": dirpath,
                 "neval": (manifest.get("meta") or {}).get("neval")}
            m.update(meta or {})
            return self.publish(params, version=version, meta=m)

    # -------------------------------------------------------------- status
    def status(self, version: int) -> dict:
        try:
            return ckpt_file.load(os.path.join(self._dir(version), STATUS))
        except (FileNotFoundError, CheckpointCorruptError):
            return {"version": int(version), "status": "unknown",
                    "history": []}

    def set_status(self, version: int, status: str, **info) -> None:
        """Atomically rewrite the version's status file, appending the
        transition to its history."""
        if status not in STATUSES:
            raise ValueError(f"unknown status {status!r}; one of {STATUSES}")
        with self._lock:
            cur = self.status(version)
            cur.setdefault("history", []).append(
                {"status": cur.get("status"), "t": time.time()})
            cur["status"] = status
            cur.update(info)
            ckpt_file.save(cur, os.path.join(self._dir(version), STATUS))
        events.record("registry_status", version=int(version), status=status)

    # ------------------------------------------------------------- loading
    def load(self, version: int) -> dict:
        """The raw artifact payload (corrupt file raises
        :class:`CheckpointCorruptError`)."""
        return ckpt_file.load(os.path.join(self._dir(version), ARTIFACT))

    def resolve_params(self, version: int):
        """Full params tree for ``version`` — a LoRA artifact is overlaid
        onto its base version's tree (structure identical to the base, only
        the adapter leaves replaced)."""
        payload = self.load(version)
        if payload["kind"] == "full":
            return payload["params"]
        base = self.load(payload["base_version"])
        if base["kind"] != "full":
            raise CheckpointCorruptError(
                self._dir(version),
                f"lora base v{payload['base_version']} is not a full "
                f"artifact")
        tree = _copy_tree(base["params"])
        for path, arr in payload["delta"].items():
            _set_path(tree, path, arr)
        return tree

    # ------------------------------------------------------------- pruning
    def prune(self, protect: tuple = ()) -> list:
        """Drop oldest versions beyond ``keep``, never removing promoted
        versions, the newest version, explicitly protected ones, or a lora
        base still referenced by a surviving artifact. Returns the versions
        removed."""
        if self.keep <= 0:
            return []
        with self._lock:
            have = self.versions()
            if len(have) <= self.keep:
                return []
            referenced = set()
            for v in have:
                try:
                    payload = self.load(v)
                except (FileNotFoundError, CheckpointCorruptError):
                    continue
                if payload.get("base_version") is not None:
                    referenced.add(int(payload["base_version"]))
            removed = []
            excess = len(have) - self.keep
            for v in have[:-1]:  # never the newest
                if excess <= 0:
                    break
                if v in protect or v in referenced:
                    continue
                if self.status(v).get("status") == "promoted":
                    continue
                shutil.rmtree(self._dir(v), ignore_errors=True)
                removed.append(v)
                excess -= 1
            if removed:
                logger.info("registry: pruned versions %s", removed)
            return removed

    # --------------------------------------------------------------- state
    def state(self) -> dict:
        """Scrape-friendly summary (published to ``/statusz`` by the
        promotion controller)."""
        with self._lock:
            out = []
            for v in self.versions():
                st = self.status(v)
                out.append({"version": v, "status": st.get("status"),
                            "kind": st.get("kind")})
            return {"path": self.path, "keep": self.keep, "versions": out,
                    "promoted": self.latest("promoted")}


def from_env() -> Optional[ModelRegistry]:
    """A registry at ``BIGDL_REGISTRY_DIR``, or None when unset."""
    path = os.environ.get("BIGDL_REGISTRY_DIR")
    if not path:
        return None
    return ModelRegistry(path)
